"""The comparison that decides `correct`: what the timed path produced for a
sample of the window's finished requests, judged stage by stage against
the plain reference (`reference/<name>/pipeline.py`), which makes the
weights again from the seed and takes nothing the program made.

Each stage is judged from the inputs the program gave that stage, and the
start (the conditioning) from the raw prompt alone:

- `missing`: sampled requests whose rows the engine calls do not show (a
  request that never came, or whose text ids the program got wrong, is
  missing);
- `wav_len`: served WAVs whose sample count is not the reference's
  target frames x hop for the codes served (exact);
- `wav_lsb`: the widest gap, in int16 steps, between the served WAV and the
  reference's waveform of the program's mel cut to int16;
- `cond_err`: the conditioning the program's stages were given (cond
  latents, emotion vector, style, prompt mel), relative L2 error against
  the reference's from the prompt's bytes;
- `vq_err`: the prompt condition the s2mel was given (RepCodec's
  vector-quantized codes through the length regulator), the same way: a
  rounding that moves a frame across a codebook boundary moves it a whole
  codebook step, so a configuration whose conditioning runs below f32
  does not compare it (its limits file leaves it out);
- `latent_err`: the GPT's teacher-forced latent over the served codes;
- `token_gap`: the widest gap by which a served code's processed score
  (repetition penalty and temperature, as the decode applies them) lies
  below the reference's top-k cut-off at its position: a served code the
  decode could not have drawn reads above 0;
- `mel_err`: the s2mel's mel from the program's latent, codes,
  conditioning and initial noise;
- `wave_err`: the vocoder's float waveform from the program's mel.

The relative errors are ||program - reference|| / ||reference|| over a
request's valid frames; each number is the worst over the sample.
"""

from __future__ import annotations

import io
import wave
from typing import Dict, List, Optional

import numpy as np
import torch

NUMBERS = ("missing", "wav_len", "wav_lsb", "cond_err", "vq_err", "latent_err",
           "token_gap", "mel_err", "wave_err")
COND_PARTS = ("cond_latents", "emovec", "style", "ref_mel")


def rel_err(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.float().reshape(-1), r.float().reshape(-1).to(p.device)
    den = torch.linalg.vector_norm(r).item()
    return torch.linalg.vector_norm(p - r).item() / max(den, 1e-30)


def find_row(calls: List[Dict], ids: List[int]) -> Optional[tuple]:
    """(unit, row) of the engine call whose GPT latent input holds `ids` as
    a row's text, the first such row."""
    want = torch.tensor(ids, dtype=torch.long)
    for call in calls:
        for unit in call["units"]:
            text, tlen = unit["gpt"][2], unit["gpt"][3]
            for i in range(text.shape[0]):
                n = int(tlen[i])
                if n == len(ids) and torch.equal(text[i, :n].cpu(), want):
                    return unit, i
    return None


def processed(logits: torch.Tensor, codes: torch.Tensor, gen: Dict,
              start_mel: int, beam: bool) -> torch.Tensor:
    """The decode's scores before top-k / top-p at each position, given the
    served prefix: repetition penalty over the codes so far (and token 1
    and start_mel) on the log-probs (beam) or the logits (sampling), then
    temperature."""
    n, vocab = logits.shape
    s = torch.log_softmax(logits, dim=-1) if beam else logits.clone()
    presence = torch.zeros((n, vocab), dtype=torch.bool, device=logits.device)
    presence[:, 1] = True
    presence[:, start_mel] = True
    if n > 1:
        prev = torch.zeros((n, vocab), dtype=torch.bool, device=logits.device)
        prev[torch.arange(1, n, device=logits.device), codes[:-1]] = True
        presence |= torch.cumsum(prev.int(), dim=0) > 0
    pen = gen["repetition_penalty"]
    if pen != 1.0:
        s = torch.where(presence, torch.where(s > 0, s / pen, s * pen), s)
    if gen["do_sample"] and gen["temperature"] != 1.0:
        s = s / gen["temperature"]
    return s


def token_gap(logits: torch.Tensor, codes: torch.Tensor, cfg: Dict) -> float:
    gen = cfg["generation"]
    s = processed(logits, codes, gen, cfg["gpt"]["start_mel_token"],
                  gen["num_beams"] > 1)
    k = min(gen["top_k"] if gen["top_k"] > 0 else s.shape[-1], s.shape[-1])
    cut = torch.topk(s, k, dim=-1).values[:, -1]
    served = s.gather(1, codes[:, None].to(s.device))[:, 0]
    return float(torch.clamp(cut - served, min=0).max().item()) if len(codes) else 0.0


def wav_samples(data: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(data)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)


def judge(ref, cfg: Dict, sample: List[Dict], calls: List[Dict], prompts: Dict[str, bytes],
          served: Dict[int, bytes]) -> tuple:
    """The numbers over `sample` (request records with "id", "text",
    "voice"), and the conditioning's error a part; `served` maps a request
    id to the WAV it got."""
    out = {k: 0.0 for k in NUMBERS}
    parts: Dict[str, float] = {}
    hop = cfg["mel"]["hop_size"]
    cond_cache: Dict[str, Dict] = {}
    for req in sample:
        ids = ref.text_ids(req["text"])
        found = find_row(calls, ids)
        if found is None or req["id"] not in served:
            out["missing"] += 1
            continue
        unit, i = found
        cond_lat, emo, text, tlen, codes, clen = (t[i:i + 1] for t in unit["gpt"])
        s2 = unit.get("s2mel")
        if s2 is None or "wave" not in unit:
            out["missing"] += 1
            continue
        n_codes = int(clen[0])
        # the conditioning, from the prompt's bytes
        voice = req["voice"]
        if voice not in cond_cache:
            cond_cache[voice] = ref.conditioning(prompts[voice])
        rc = cond_cache[voice]
        pl = int(s2["prompt_len"][i])
        errs = {"cond_latents": rel_err(cond_lat, rc["cond_latents"]),
                "emovec": rel_err(emo, rc["emovec"]),
                "style": rel_err(s2["style"][i:i + 1], rc["style"]),
                "prompt_condition": rel_err(s2["prompt_condition"][i, :pl],
                                            rc["prompt_condition"][0, :pl]),
                "ref_mel": rel_err(s2["ref_mel"][i, :, :pl], rc["ref_mel"][0, :, :pl])}
        for k, v in errs.items():
            parts[k] = max(parts.get(k, 0.0), v)
        out["cond_err"] = max(out["cond_err"], *(errs[k] for k in COND_PARTS))
        out["vq_err"] = max(out["vq_err"], errs["prompt_condition"])
        # the GPT: the latent, and the served codes against the decode's logits
        lat = ref.latent(cond_lat, emo, text[0], int(tlen[0]), codes[0], n_codes)
        out["latent_err"] = max(out["latent_err"],
                                rel_err(unit["latent"][i, :n_codes], lat[:n_codes]))
        served_codes = codes[0, :n_codes]
        logits = ref.decode_logits(cond_lat, emo, ids, served_codes)
        out["token_gap"] = max(out["token_gap"],
                               token_gap(logits, served_codes.to(logits.device), cfg))
        # the s2mel, from the program's inputs and noise
        tl = int(s2["target_len"][i])
        mel = ref.s2mel(unit["latent"][i:i + 1], s2["codes"][i:i + 1],
                        s2["code_len"][i:i + 1], s2["prompt_condition"][i:i + 1],
                        s2["prompt_len"][i:i + 1], s2["ref_mel"][i:i + 1],
                        s2["style"][i:i + 1], s2["mel_bucket"], s2["noise"][i:i + 1])
        out["mel_err"] = max(out["mel_err"], rel_err(s2["mel"][i, :, :tl], mel[0, :, :tl]))
        # the vocoder, from the program's mel
        wav_ref = ref.vocode(s2["mel"][i:i + 1])
        # the engine cuts the vocoder's output to target frames x hop
        n = min(tl * hop, wav_ref.shape[0])
        out["wave_err"] = max(out["wave_err"],
                              rel_err(unit["wave"][i].reshape(-1)[:n], wav_ref[:n]))
        # the served WAV
        got = wav_samples(served[req["id"]])
        want_n = min(ref.target_len(n_codes) * hop, wav_ref.shape[0])
        if len(got) != want_n or n != want_n:
            out["wav_len"] += 1
        ref16 = torch.clamp(wav_ref[:n] * 32767.0, -32767.0, 32767.0).to(torch.int16)
        m = min(len(got), n)
        if m:
            gap = np.abs(got[:m].astype(np.int32) - ref16[:m].cpu().numpy().astype(np.int32))
            out["wav_lsb"] = max(out["wav_lsb"], float(gap.max()))
    return out, parts


def control_gap(ref_logits: torch.Tensor, ctl_logits: torch.Tensor, codes: torch.Tensor,
                cfg: Dict) -> float:
    """`token_gap` of the codes a lower precision could draw: at each
    position of the served prefix, the control's last admissible candidate
    (its k-th best processed score), against the reference's cut-off."""
    gen = cfg["generation"]
    beam = gen["num_beams"] > 1
    start = cfg["gpt"]["start_mel_token"]
    s_ref = processed(ref_logits, codes, gen, start, beam)
    s_ctl = processed(ctl_logits, codes, gen, start, beam)
    k = min(gen["top_k"] if gen["top_k"] > 0 else s_ref.shape[-1], s_ref.shape[-1])
    cut = torch.topk(s_ref, k, dim=-1).values[:, -1]
    worst = torch.topk(s_ctl, k, dim=-1).indices[:, -1:]
    return float(torch.clamp(cut - s_ref.gather(1, worst)[:, 0], min=0).max().item())


def judge_control(ref, ctl, cfg: Dict, sample: List[Dict], calls: List[Dict],
                  prompts: Dict[str, bytes]) -> Dict[str, float]:
    """The control's numbers: the reference computed one step below the
    configuration's precision (`ctl`) put in the program's place, each stage
    from the inputs the program gave it, judged as `judge` judges the
    program."""
    out = {k: 0.0 for k in ("cond_err", "vq_err", "latent_err", "token_gap", "mel_err",
                            "wave_err")}
    parts: Dict[str, float] = {}
    hop = cfg["mel"]["hop_size"]
    for req in sample:
        ids = ref.text_ids(req["text"])
        found = find_row(calls, ids)
        if found is None:
            continue
        unit, i = found
        cond_lat, emo, text, tlen, codes, clen = (t[i:i + 1] for t in unit["gpt"])
        s2 = unit["s2mel"]
        n_codes = int(clen[0])
        rc, cc = ref.conditioning(prompts[req["voice"]]), ctl.conditioning(prompts[req["voice"]])
        for k in COND_PARTS + ("prompt_condition",):
            parts[k] = max(parts.get(k, 0.0), rel_err(cc[k], rc[k]))
        out["cond_err"] = max(out["cond_err"], *(parts[k] for k in COND_PARTS))
        out["vq_err"] = max(out["vq_err"], parts["prompt_condition"])
        args = (cond_lat, emo, text[0], int(tlen[0]), codes[0], n_codes)
        out["latent_err"] = max(out["latent_err"], rel_err(ctl.latent(*args)[:n_codes],
                                                           ref.latent(*args)[:n_codes]))
        served = codes[0, :n_codes]
        rl = ref.decode_logits(cond_lat, emo, ids, served)
        cl = ctl.decode_logits(cond_lat, emo, ids, served)
        out["token_gap"] = max(out["token_gap"],
                               control_gap(rl, cl.to(rl.device), served.to(rl.device), cfg))
        tl = int(s2["target_len"][i])
        s2_args = (unit["latent"][i:i + 1], s2["codes"][i:i + 1], s2["code_len"][i:i + 1],
                   s2["prompt_condition"][i:i + 1], s2["prompt_len"][i:i + 1],
                   s2["ref_mel"][i:i + 1], s2["style"][i:i + 1], s2["mel_bucket"],
                   s2["noise"][i:i + 1])
        out["mel_err"] = max(out["mel_err"], rel_err(ctl.s2mel(*s2_args)[0, :, :tl],
                                                     ref.s2mel(*s2_args)[0, :, :tl]))
        mel = s2["mel"][i:i + 1]
        wr, wc = ref.vocode(mel), ctl.vocode(mel)
        n = min(tl * hop, wr.shape[0])
        out["wave_err"] = max(out["wave_err"], rel_err(wc[:n], wr[:n]))
    return out, parts
