"""Model artifact directory: converted weights + config + extras
(`voice_tts_tpu/utils/artifacts.py`), in the port's own layout:

    <dir>/config.json        TTSConfig (`to_dict`)
    <dir>/<family>.pt        the port module's state_dict (torch.save)
    <dir>/extras.pt          w2v stats, emo / spk matrices
    <dir>/bpe.model          sentencepiece model (optional)

Every `.pt` file holds only tensors in dicts and lists, so it loads with
`weights_only=True`.  `convert_reference_artifacts` maps the published
torch / safetensors checkpoint files into this layout through the
per-family converters of `utils.checkpoint`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from voice_tts_tpu_torch.config import TTSConfig
from voice_tts_tpu_torch.utils import checkpoint as ckpt
from voice_tts_tpu_torch.utils.convert import FAMILIES


def save_artifacts(directory: str, cfg: TTSConfig, states: Dict[str, dict],
                   extras: Optional[Dict] = None,
                   bpe_model_bytes: Optional[bytes] = None) -> None:
    """Write `states` (family -> state_dict), `extras` (name -> array or
    list of arrays) and the optional sentencepiece model under `directory`."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        f.write(cfg.to_json(indent=2))
    for family in FAMILIES:
        if family in states:
            torch.save({k: v.detach().cpu().contiguous()
                        for k, v in states[family].items()},
                       os.path.join(directory, f"{family}.pt"))
    if extras:
        packed = {k: ([torch.as_tensor(np.asarray(x)) for x in v]
                      if isinstance(v, (list, tuple)) else torch.as_tensor(np.asarray(v)))
                  for k, v in extras.items()}
        torch.save(packed, os.path.join(directory, "extras.pt"))
    if bpe_model_bytes:
        with open(os.path.join(directory, "bpe.model"), "wb") as f:
            f.write(bpe_model_bytes)


def load_artifacts(directory: str):
    """-> (cfg, states, extras, bpe bytes or None); extras as numpy arrays
    (lists of them for the per-emotion groups)."""
    with open(os.path.join(directory, "config.json")) as f:
        cfg = TTSConfig.from_json(f.read())
    states = {}
    for family in FAMILIES:
        path = os.path.join(directory, f"{family}.pt")
        if os.path.exists(path):
            states[family] = torch.load(path, map_location="cpu", weights_only=True)
    extras = {}
    epath = os.path.join(directory, "extras.pt")
    if os.path.exists(epath):
        for k, v in torch.load(epath, map_location="cpu", weights_only=True).items():
            extras[k] = ([x.numpy() for x in v] if isinstance(v, (list, tuple))
                         else v.numpy())
    bpe = None
    bpath = os.path.join(directory, "bpe.model")
    if os.path.exists(bpath):
        with open(bpath, "rb") as f:
            bpe = f.read()
    return cfg, states, extras, bpe


def load_matrix(path: str) -> np.ndarray:
    """An emo / spk matrix file: a bare tensor (as the reference saves and
    loads them) or a state dict holding the one matrix."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return next(iter(ckpt.load_state_dict(path).values())).numpy()


def convert_reference_artifacts(cfg: TTSConfig, gpt_checkpoint: Optional[str] = None,
                                s2mel_checkpoint: Optional[str] = None,
                                vocoder_checkpoint: Optional[str] = None,
                                campplus_checkpoint: Optional[str] = None,
                                semantic_codec_checkpoint: Optional[str] = None,
                                w2v_bert_dir: Optional[str] = None,
                                w2v_stat: Optional[str] = None,
                                emo_matrix: Optional[str] = None,
                                spk_matrix: Optional[str] = None) -> tuple:
    """The published checkpoint files -> (states, extras) in this layout."""
    states: Dict[str, dict] = {}
    extras: Dict[str, np.ndarray] = {}
    if gpt_checkpoint:
        states["gpt"] = ckpt.convert_unified_voice(ckpt.load_state_dict(gpt_checkpoint))
    if s2mel_checkpoint:
        states["s2mel"] = ckpt.convert_s2mel(
            ckpt.load_state_dict(s2mel_checkpoint),
            cfg.s2mel.length_regulator.num_sampling_ratios)
    if vocoder_checkpoint:
        states["vocoder"] = ckpt.convert_bigvgan(ckpt.load_state_dict(vocoder_checkpoint))
    if campplus_checkpoint:
        states["campplus"] = ckpt.convert_campplus(ckpt.load_state_dict(campplus_checkpoint))
    if semantic_codec_checkpoint:
        states["repcodec"] = ckpt.convert_repcodec(
            ckpt.load_state_dict(semantic_codec_checkpoint))
    if w2v_bert_dir:
        states["w2v"] = ckpt.convert_w2v_bert(
            ckpt.load_state_dict(os.path.join(w2v_bert_dir, "model.safetensors")),
            cfg.w2v_bert.output_layer)
    if w2v_stat:
        extras.update(w2v_stats(w2v_stat))
    if emo_matrix:
        extras["emo_matrix_raw"] = load_matrix(emo_matrix)
    if spk_matrix:
        extras["spk_matrix_raw"] = load_matrix(spk_matrix)
    return states, extras


def w2v_stats(path: str) -> Dict[str, np.ndarray]:
    """The w2v-bert feature statistics file -> {w2v_mean, w2v_std = sqrt(var)}."""
    stats = ckpt.load_state_dict(path)
    return {"w2v_mean": stats["mean"].numpy(),
            "w2v_std": np.sqrt(stats["var"].numpy())}


def split_matrix_groups(matrix: np.ndarray, emo_num) -> list:
    """Split a stacked emo / spk matrix into per-emotion groups of `emo_num`
    rows each (torch.split semantics)."""
    out = []
    offset = 0
    for n in emo_num:
        out.append(np.asarray(matrix[offset:offset + n]))
        offset += n
    return out
