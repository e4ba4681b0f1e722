"""Text -> emotion-vector analysis through a Qwen chat model
(`voice_tts_tpu/engine/qwen_emotion.py`).

Behaviour of the reference `QwenEmotion` (`infer_v2.py:795-906`): the
"文本情感分类" system prompt, the JSON parse with a regex fallback, the
sad <-> melancholic swap, scores clamped to 0..1.2, the calm fallback, the
canonical zh key order.  The LM is the port's `models/qwen.py`, its greedy
decode a device loop.  The tokenizer is injected (an object with
`apply_chat_template`, `__call__`, `decode` and `eos_token_id`, as a
Hugging Face tokenizer has); `from_pretrained` loads one with
`transformers`, imported there only, from a local model directory (no
network).
"""

from __future__ import annotations

import json
import re
from typing import Dict, Optional

import torch

from voice_tts_tpu_torch.config import QwenEmoConfig
from voice_tts_tpu_torch.engine.device_loop import DeviceLoops
from voice_tts_tpu_torch.models.qwen import QwenLM, qwen_greedy_decode

CN_KEY_TO_EN = {
    "高兴": "happy", "愤怒": "angry", "悲伤": "sad", "恐惧": "afraid",
    "反感": "disgusted", "低落": "melancholic", "惊讶": "surprised",
    "自然": "calm",
}
DESIRED_ORDER = ["高兴", "愤怒", "悲伤", "恐惧", "反感", "低落", "惊讶", "自然"]
MELANCHOLIC_WORDS = {"低落", "melancholy", "melancholic", "depression",
                     "depressed", "gloomy"}
MAX_SCORE, MIN_SCORE = 1.2, 0.0


def parse_emotion_response(content: str, text_input: str) -> Dict[str, float]:
    """JSON (or regex-salvaged) response -> ordered english emotion dict."""
    try:
        parsed = json.loads(content)
    except json.JSONDecodeError:
        parsed = {m.group(1): float(m.group(2))
                  for m in re.finditer(r'([^\s":.,]+?)"?\s*:\s*([\d.]+)', content)}

    # sad <-> melancholic swap when melancholic cue words present
    lower = text_input.lower()
    if any(w in lower for w in MELANCHOLIC_WORDS):
        parsed["悲伤"], parsed["低落"] = parsed.get("低落", 0.0), parsed.get("悲伤", 0.0)

    out = {CN_KEY_TO_EN[k]: max(MIN_SCORE, min(MAX_SCORE, float(parsed.get(k, 0.0))))
           for k in DESIRED_ORDER}
    if all(v <= 0.0 for v in out.values()):
        out["calm"] = 1.0
    return out


class QwenEmotion:
    """The Qwen LM and a tokenizer behind the reference interface:
    `inference(text) -> {emotion: score}`.  The decode's graphs are kept in
    `loops` (made on the first call on a card; set it to
    `DeviceLoops(dev, capture=False)` to run the steps op by op)."""

    PROMPT = "文本情感分类"

    def __init__(self, cfg: QwenEmoConfig, model: QwenLM, tokenizer,
                 prompt_bucket: int = 128, loops: Optional[DeviceLoops] = None):
        self.cfg = cfg
        self.model = model
        self.tokenizer = tokenizer
        self.prompt_bucket = prompt_bucket
        self.loops = loops

    @classmethod
    def from_pretrained(cls, model_dir: str, cfg: Optional[QwenEmoConfig] = None,
                        device="cuda"):
        """Load and convert a local HF Qwen2 / Qwen3 checkpoint directory
        (safetensors shards, else torch .bin files) onto `device`."""
        import glob
        import os

        from transformers import AutoConfig, AutoTokenizer

        from voice_tts_tpu_torch.engine.engine import resolve_device
        from voice_tts_tpu_torch.models.qwen import QwenArch, load_qwen_state
        from voice_tts_tpu_torch.utils.checkpoint import convert_qwen, load_state_dict

        hf_cfg = AutoConfig.from_pretrained(model_dir)
        arch = QwenArch(
            vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
            num_layers=hf_cfg.num_hidden_layers,
            num_heads=hf_cfg.num_attention_heads,
            num_kv_heads=hf_cfg.num_key_value_heads,
            head_dim=getattr(hf_cfg, "head_dim", None)
            or hf_cfg.hidden_size // hf_cfg.num_attention_heads,
            intermediate_size=hf_cfg.intermediate_size,
            rope_theta=getattr(hf_cfg, "rope_theta", 1e6),
            rms_eps=getattr(hf_cfg, "rms_norm_eps", 1e-6),
            qkv_bias=hf_cfg.model_type == "qwen2",
            qk_norm=hf_cfg.model_type == "qwen3",
            tie_embeddings=getattr(hf_cfg, "tie_word_embeddings", True),
        )
        sd = {}
        for path in sorted(glob.glob(os.path.join(model_dir, "*.safetensors"))):
            sd.update(load_state_dict(path))
        if not sd:
            for path in sorted(glob.glob(os.path.join(model_dir, "*.bin"))):
                sd.update(load_state_dict(path))
        model = load_qwen_state(QwenLM(arch), convert_qwen(sd))
        model = model.to(resolve_device(device)).eval()
        tokenizer = AutoTokenizer.from_pretrained(model_dir)
        return cls(cfg or QwenEmoConfig(), model, tokenizer)

    def _chat_tokens(self, text_input: str):
        messages = [
            {"role": "system", "content": self.PROMPT},
            {"role": "user", "content": text_input},
        ]
        try:
            text = self.tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True,
                enable_thinking=False)
        except TypeError:
            text = self.tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        return self.tokenizer(text)["input_ids"]

    def inference(self, text_input: str) -> Dict[str, float]:
        """The emotion dict of `text_input`: the chat prompt left-padded with
        eos into a bucket of 128 tokens (doubled until it fits), greedy
        decode, the ids up to the first eos decoded, `<think>` blocks
        stripped, then `parse_emotion_response`."""
        ids = self._chat_tokens(text_input)
        bucket = self.prompt_bucket
        while bucket < len(ids):
            bucket *= 2
        eos = int(self.tokenizer.eos_token_id)
        dev = self.model.embed_tokens.weight.device
        tokens = torch.full((1, bucket), eos, dtype=torch.long)
        tokens[0, bucket - len(ids):] = torch.as_tensor(ids, dtype=torch.long)
        if dev.type == "cuda" and self.loops is None:
            self.loops = DeviceLoops(dev)
        res = qwen_greedy_decode(self.model, tokens.to(dev), len(ids),
                                 self.cfg.max_new_tokens, eos, loops=self.loops)
        out_ids = res.ids[0].tolist()
        if eos in out_ids:
            out_ids = out_ids[: out_ids.index(eos)]
        content = self.tokenizer.decode(out_ids, skip_special_tokens=True)
        # strip <think> blocks if the model emits them
        content = re.sub(r"<think>.*?</think>", "", content, flags=re.S).strip()
        return parse_emotion_response(content, text_input)
