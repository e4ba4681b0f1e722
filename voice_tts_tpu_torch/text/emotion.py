"""Emotion label normalization -> canonical 8-dim vector.

Same capability as reference `emotion.py`: map zh/en emotion labels and their
synonyms onto the fixed order
[happy, angry, sad, afraid, disgusted, melancholic, surprised, calm]
(`emotion.py:27`), accepting a single label + alpha or a {label: weight}
dict (max-merge on collisions, unknown labels default to calm).
"""

from __future__ import annotations

from typing import Dict, List, Union

EMOTIONS = ["happy", "angry", "sad", "afraid", "disgusted", "melancholic",
            "surprised", "calm"]

_SYNONYMS: Dict[str, List[str]] = {
    "happy": ["happiness", "joy", "joyful", "cheerful", "delighted", "pleased",
              "excited", "glad", "elated", "高兴", "快乐", "开心", "愉快",
              "欢乐", "喜悦", "兴奋", "欣喜", "高兴的", "快活"],
    "angry": ["anger", "mad", "furious", "irritated", "annoyed", "enraged",
              "outraged", "愤怒", "生气", "发怒", "恼怒", "气愤", "火大",
              "暴怒", "愤慨"],
    "sad": ["sadness", "unhappy", "sorrow", "sorrowful", "grief", "heartbroken",
            "mournful", "悲伤", "难过", "伤心", "忧伤", "哀伤", "痛苦",
            "悲痛", "悲哀"],
    "afraid": ["fear", "fearful", "scared", "frightened", "terrified",
               "anxious", "nervous", "panic", "panicked", "恐惧", "害怕",
               "恐慌", "惊恐", "畏惧", "紧张", "胆怯"],
    "disgusted": ["disgust", "disgusting", "repulsed", "revolted", "nauseated",
                  "反感", "厌恶", "恶心", "讨厌", "反胃", "嫌弃", "憎恶"],
    "melancholic": ["melancholy", "depressed", "depression", "gloomy",
                    "downcast", "dejected", "despondent", "blue", "低落",
                    "忧郁", "沮丧", "消沉", "抑郁", "颓废", "低沉", "郁闷"],
    "surprised": ["surprise", "astonished", "amazed", "shocked", "startled",
                  "stunned", "惊讶", "吃惊", "震惊", "惊奇", "诧异", "惊诧",
                  "愕然", "意外"],
    "calm": ["normal", "calmness", "peaceful", "serene", "tranquil", "relaxed",
             "composed", "neutral", "natural", "平静", "自然", "淡定", "平和",
             "安静", "宁静", "放松", "冷静", "中性", "平淡"],
}

EMOTION_MAPPING: Dict[str, str] = {}
for _canon, _syns in _SYNONYMS.items():
    EMOTION_MAPPING[_canon] = _canon
    for _s in _syns:
        EMOTION_MAPPING[_s] = _canon


def normalize_emotion_label(label: str) -> str:
    """Map any synonym to a canonical emotion; unknown -> 'calm'."""
    return EMOTION_MAPPING.get(label.strip().lower(), "calm")


def normalize_emotion_dict(emotion_input: Dict[str, float]) -> Dict[str, float]:
    out = {e: 0.0 for e in EMOTIONS}
    for label, value in emotion_input.items():
        canon = normalize_emotion_label(label)
        out[canon] = max(out[canon], float(value))
    return out


def emotion_dict_to_vector(emotion_dict: Dict[str, float]) -> List[float]:
    return [emotion_dict.get(e, 0.0) for e in EMOTIONS]


def create_emotion_vector(emotion_input: Union[str, Dict[str, float]],
                          alpha: float = 1.0) -> List[float]:
    """Label string (+ alpha) or {label: weight} dict -> 8-dim vector."""
    if isinstance(emotion_input, str):
        canon = normalize_emotion_label(emotion_input)
        return emotion_dict_to_vector(normalize_emotion_dict({canon: alpha}))
    if isinstance(emotion_input, dict):
        return emotion_dict_to_vector(normalize_emotion_dict(emotion_input))
    raise TypeError(f"emotion_input must be str or dict, got {type(emotion_input)}")


def normalize_emo_vec(emo_vector: List[float], apply_bias: bool = True) -> List[float]:
    """Per-emotion bias + 0.8 sum cap (reference `infer_v2.py:421-435`)."""
    if apply_bias:
        bias = [0.9375, 0.875, 1.0, 1.0, 0.9375, 0.9375, 0.6875, 0.5625]
        emo_vector = [v * b for v, b in zip(emo_vector, bias)]
    total = sum(emo_vector)
    if total > 0.8:
        emo_vector = [v * (0.8 / total) for v in emo_vector]
    return emo_vector
