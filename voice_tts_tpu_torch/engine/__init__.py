"""Inference engine of the port (`voice_tts_tpu.engine`)."""
