from voice_tts_tpu_torch.text.tokenizer import SentencePieceBPE, TextTokenizer
from voice_tts_tpu_torch.text.normalizer import TextNormalizer
from voice_tts_tpu_torch.text.emotion import (
    EMOTIONS, create_emotion_vector, normalize_emotion_label,
)

__all__ = ["SentencePieceBPE", "TextTokenizer", "TextNormalizer", "EMOTIONS",
           "create_emotion_vector", "normalize_emotion_label"]
