"""Audio frontend: WAV IO, resampling, STFT / mel, kaldi fbank, seamless
features (`voice_tts_tpu.audio`)."""

from voice_tts_tpu_torch.audio.kaldi import KaldiFbank, SeamlessFeatures
from voice_tts_tpu_torch.audio.mel import MelSpectrogram
from voice_tts_tpu_torch.audio.resample import Resampler
from voice_tts_tpu_torch.audio.wav import (decode_audio_bytes, encode_wav_int16,
                                           load_prompt_audio)

__all__ = ["KaldiFbank", "SeamlessFeatures", "MelSpectrogram", "Resampler",
           "decode_audio_bytes", "encode_wav_int16", "load_prompt_audio"]
