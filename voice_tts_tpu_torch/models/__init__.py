"""Model families of the port (counterparts of voice_tts_tpu.models)."""
