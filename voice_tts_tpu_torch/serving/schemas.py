"""Request / response schemas of the TTS API as stdlib dataclasses.

Same fields and validation rules as `voice_tts_tpu/serving/schemas.py`
(pydantic there; the GPU machine has no pydantic): `text` and `spk_audio`
are required strings, `emo_audio` an optional string, `emotion` an optional
label or {label: weight in [0, 1]} dict, `emo_alpha` a number in [0, 1]
(default 1.0).  Numbers are read as pydantic's lax mode reads a float field
(bools and numeric strings too).  `TTSRequest.from_json` raises
`ValidationError` with a
pydantic-style error list, which the server answers with 422.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union


class ValidationError(ValueError):
    def __init__(self, errors: List[Dict[str, Any]]):
        super().__init__("; ".join(f"{'.'.join(map(str, e['loc']))}: {e['msg']}"
                                   for e in errors))
        self._errors = errors

    def errors(self) -> List[Dict[str, Any]]:
        return list(self._errors)


def _lax_float(v) -> Optional[float]:
    """The value pydantic's lax `float` field accepts (numbers, bools and
    numeric strings), or None where it would refuse it."""
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            return None
    return None


@dataclasses.dataclass
class TTSRequest:
    text: str
    spk_audio: str
    emo_audio: Optional[str] = None
    emotion: Optional[Union[str, Dict[str, float]]] = None
    emo_alpha: float = 1.0

    @classmethod
    def from_json(cls, body: Any) -> "TTSRequest":
        """Validate a decoded JSON body; raises ValidationError."""
        if not isinstance(body, dict):
            raise ValidationError([{"type": "model_type", "loc": (),
                                    "msg": "Input should be a valid dictionary",
                                    "input": body}])
        errors: List[Dict[str, Any]] = []

        def err(field, kind, msg):
            errors.append({"type": kind, "loc": (field,), "msg": msg,
                           "input": body.get(field)})

        for field in ("text", "spk_audio"):
            if field not in body:
                err(field, "missing", "Field required")
            elif not isinstance(body[field], str):
                err(field, "string_type", "Input should be a valid string")
        emo_audio = body.get("emo_audio")
        if emo_audio is not None and not isinstance(emo_audio, str):
            err("emo_audio", "string_type", "Input should be a valid string")
        alpha = _lax_float(body.get("emo_alpha", 1.0))
        if alpha is None:
            err("emo_alpha", "float_type", "Input should be a valid number")
        elif not 0.0 <= alpha <= 1.0:
            err("emo_alpha", "value_error",
                "Value error, emo_alpha must be between 0.0 and 1.0")
        emotion = body.get("emotion")
        if isinstance(emotion, dict):
            emotion = {key: _lax_float(value) for key, value in emotion.items()}
            for value in emotion.values():
                if value is None:
                    err("emotion", "float_type", "Input should be a valid number")
                elif not 0.0 <= value <= 1.0:
                    err("emotion", "value_error",
                        "Value error, emotion values must be between 0.0 and 1.0")
        elif emotion is not None and not isinstance(emotion, str):
            err("emotion", "value_error",
                "Value error, emotion must be a string or dict")
        if errors:
            raise ValidationError(errors)
        return cls(text=body["text"], spk_audio=body["spk_audio"],
                   emo_audio=body.get("emo_audio"), emotion=emotion,
                   emo_alpha=alpha)


@dataclasses.dataclass
class TTSResponse:
    audio_hex: str
    audio_length: float
    inference_time: float
    rtf: float
    text: str

    def model_dump(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
