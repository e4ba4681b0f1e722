"""The UnifiedVoice training step over a dp x tp mesh
(`voice_tts_tpu/parallel/training.py`).

`gpt_loss` is the teacher-forced dual cross-entropy of the JAX package
(the dual-head objective of the reference's `model_v2.py:486-512`);
`make_train_step` shards a copy of the model over each dp index's row of
the mesh (`shard_gpt`), runs each row on its slice of the batch, averages
the gradients over dp in index order, and steps every row's optimizer
with them, so every dp replica stays equal and each tp shard is updated in
place.  The JAX step is one `jax.value_and_grad` of the plain forward;
here autograd runs through the same forward, the trunk's einsum attention
included (no hand kernel runs on this path).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn.functional as F

from voice_tts_tpu_torch.models.gpt.unified_voice import UnifiedVoice
from voice_tts_tpu_torch.parallel.mesh import Mesh
from voice_tts_tpu_torch.parallel.tp import shard_gpt

Optimizer = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def gpt_loss(model: UnifiedVoice, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Teacher-forced dual cross-entropy, `mean(text CE) * 0.01 + mean(mel
    CE)` (JAX `gpt_loss`, `training.py:25-79`).

    batch: spk_cond (B, Tc, C), emo_cond (B, Te, C) conditioning features,
    text (B, L), text_len (B,), codes (B, M), code_len (B,), on the model's
    lead device."""
    c = model.cfg
    cond = model.get_conditioning(batch["spk_cond"], None)
    emovec = model.get_emovec(batch["emo_cond"], None)
    text, codes = batch["text"], batch["codes"]
    b, l = text.shape
    m = codes.shape[1]
    dev = text.device

    text_in = torch.where(torch.arange(l, device=dev)[None] < batch["text_len"][:, None],
                          text, c.stop_text_token)
    mel_in = torch.where(torch.arange(m, device=dev)[None] < batch["code_len"][:, None],
                         codes, c.stop_mel_token)

    def full(value, like):
        return torch.full((b, 1), value, dtype=like.dtype, device=dev)

    def aligned(x, start, stop):
        return torch.cat([full(start, x), x], dim=1), torch.cat([x, full(stop, x)], dim=1)

    # the reference pads one stop first, then the start / stop alignment
    text_in = torch.cat([text_in, full(c.stop_text_token, text)], dim=1)
    mel_in = torch.cat([mel_in, full(c.stop_mel_token, codes)], dim=1)
    text_inp, text_tar = aligned(text_in, c.start_text_token, c.stop_text_token)
    mel_inp, mel_tar = aligned(mel_in, c.start_mel_token, c.stop_mel_token)

    conds = model.conds_latent(cond, emovec)
    text_emb = (model.text_embedding(text_inp)
                + model.text_pos_embedding(torch.arange(text_inp.shape[1], device=dev))[None])
    mel_emb = (model.mel_embedding(mel_inp)
               + model.mel_pos_embedding(torch.arange(mel_inp.shape[1], device=dev))[None])
    hidden, _ = model.gpt(torch.cat([conds, text_emb, mel_emb], dim=1))
    enc = model.final_norm(hidden[:, conds.shape[1]:])
    tl = model.text_head(enc[:, :text_inp.shape[1]])
    ml = model.mel_head(enc[:, -mel_inp.shape[1]:])
    t_loss = F.cross_entropy(tl.flatten(0, 1).float(), text_tar.flatten())
    m_loss = F.cross_entropy(ml.flatten(0, 1).float(), mel_tar.flatten())
    return t_loss * 0.01 + m_loss


def make_train_step(model: UnifiedVoice, optimizer: Optimizer, mesh: Mesh):
    """Returns (init_state, train_step) over `mesh` (axes dp and tp; a mesh
    of "tp" alone is dp 1), as the JAX `make_train_step`.

    `optimizer` is the torch counterpart of the optax transform: a callable
    taking the parameters and returning a `torch.optim.Optimizer` (for
    `optax.adamw(lr)`: `lambda ps: torch.optim.AdamW(ps, lr, weight_decay=1e-4)`).
    `init_state(params=None)` shards `model` (loaded with the state dict
    `params` when given) over each dp row and builds each row's optimizer;
    `train_step(state, batch)` splits the batch's rows in order over dp,
    and returns (state, loss): the state's replicas and optimizers stepped
    in place, the loss the mean of the rows' losses."""
    dp = mesh.shape.get("dp", 1)
    rows = [mesh.row(j) for j in range(dp)]

    def init_state(params: Optional[Dict[str, torch.Tensor]] = None):
        base = model
        if params is not None:
            base = UnifiedVoice(model.cfg)
            base.load_state_dict(params)
        replicas = [shard_gpt(base, row).train().requires_grad_(True) for row in rows]
        return {"replicas": replicas,
                "opts": [optimizer(list(r.parameters())) for r in replicas]}

    def train_step(state, batch: Dict[str, torch.Tensor]):
        n = batch["text"].shape[0]
        if n % dp:
            raise ValueError(f"batch of {n} rows does not split over dp={dp}")
        per = n // dp
        losses = []
        for j, (r, row) in enumerate(zip(state["replicas"], rows)):
            lead = row.devices[0]
            sub = {k: v[j * per:(j + 1) * per].to(lead) for k, v in batch.items()}
            r.zero_grad(set_to_none=True)
            loss = gpt_loss(r, sub)
            loss.backward()
            losses.append(loss.detach())
        # every leaf's gradient averaged over dp in index order (a leaf the
        # loss does not reach counts zero, as jax.grad gives it), then the
        # same mean on every replica
        for ps in zip(*(r.parameters() for r in state["replicas"])):
            gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
            acc = gs[0].clone()
            for g in gs[1:]:
                acc += g.to(acc.device)
            acc /= dp
            for p in ps:
                p.grad = acc.to(p.device, copy=True)
        for opt in state["opts"]:
            opt.step()
        lead = rows[0].devices[0]
        loss = losses[0].to(lead)
        for x in losses[1:]:
            loss = loss + x.to(lead)
        return state, loss / dp

    return init_state, train_step
