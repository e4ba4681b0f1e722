"""HTTP serving of the port (`voice_tts_tpu.serving`), stdlib only."""
