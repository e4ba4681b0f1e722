"""The operation and byte counts, held to hand counts at tiny shapes, and
K3's bound held against PERF.md's kernel table."""

import json

import pytest

from helpers import REPO, tiny_config
from perfbench import costs

TINY_GPT = {"gpt": {"layers": 2, "model_dim": 16, "number_mel_codes": 10},
            "engine": {"fold_readout": True}}


def test_decode_launch_hand_count():
    n_bytes, flops = costs.decode_launch(TINY_GPT, rows=3, requests=1, pos=5,
                                         kv_int8=True, table=True)
    trunk = 2 * 12 * 16 * 16
    consts = 2 * 22 * 16 * 4
    readout = 10 * (16 + 8) + 2 * 16 * 4 + 3 * 10 * 4
    kv = 2 * 2 * 5 * (16 + 4)              # one history of 5 positions
    bias = table = 4 * 3 * 5
    x_hidden = 3 * 16 * 8
    kv_new = 2 * 2 * 3 * 16 * 4
    assert n_bytes == trunk + consts + readout + kv + bias + table + x_hidden + kv_new
    assert flops == 2 * 3 * (2 * 12 * 16 * 16 + 10 * 16) + 4 * 2 * 16 * (3 * 5 + 3)


def test_decode_launch_float_kv_without_table():
    n_bytes, _ = costs.decode_launch(TINY_GPT, rows=2, requests=2, pos=4,
                                     kv_int8=False, table=False)
    kv = 2 * 2 * (2 * 4) * (2 * 16)        # two rows' histories, bf16
    assert n_bytes == (2 * 12 * 256 + 2 * 22 * 16 * 4 + 10 * 24 + 128 + 2 * 10 * 4
                       + kv + 4 * 2 * 4 + 2 * 16 * 8 + 2 * 2 * 2 * 16 * 2)


def test_k3_bound_brackets_the_kernel_table():
    """PERF.md's K3 row: 0.2033 ms at 3 rows, position 1500, int8 KV, counted
    from a real decode's ancestor table (its distinct entries).  The
    benchmark cannot see the table, so it counts one history a request (the
    least any table can name); the same formula with three histories is
    the most.  The table's bound lies between."""
    cfg = json.loads((REPO / "perfbench/configs/indextts2-beam3.json").read_text())["config"]
    lo = costs.bound_s(*costs.decode_launch(cfg, 3, 1, 1500, True, True))
    hi = costs.bound_s(*costs.decode_launch(cfg, 3, 3, 1500, True, True))
    assert lo < 0.2033e-3 < hi
    assert lo == pytest.approx(0.1726e-3, rel=2e-3)


def test_mel_frames():
    from perfbench.reference.indextts2.config import MelConfig
    from perfbench.reference.indextts2.mel import MelSpectrogram

    cfg = {"mel": {"sample_rate": 22050, "n_fft": 1024, "hop_size": 256}}
    assert costs.mel_frames(cfg, 5.0) == (110250 + 768 - 1024) // 256 + 1 == 430
    assert costs.mel_frames(cfg, 5.0) == MelSpectrogram(MelConfig()).num_frames(110250)


def test_vocoder_hand_count():
    cfg = {"vocoder": {"num_mels": 4, "upsample_initial_channel": 8,
                       "upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
                       "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 2]]}}
    pre = 2 * 4 * 8 * 7 * 10
    stage0 = 2 * 8 * 4 * 4 * 10 + 2 * 2 * (2 * 4 * 4 * 3 * 20)
    stage1 = 2 * 4 * 2 * 4 * 20 + 2 * 2 * (2 * 2 * 2 * 3 * 40)
    post = 2 * 2 * 7 * 40
    assert costs.vocoder_flops(cfg, 10) == pre + stage0 + stage1 + post


def test_request_gpt_parts_hand_count():
    cfg = tiny_config(beams=1)
    g = cfg["gpt"]
    n_layers, d, v = g["layers"], g["model_dim"], g["number_mel_codes"]
    trunk = 12 * d * d * n_layers
    parts = costs.request_flops(cfg, text_len=5, codes=4, prompt_frames=10,
                                prompt_seconds=1.0, cold=False)
    prompt = g["condition_num_latent"] + 2 + 5 + 2 + 1
    assert parts["gpt_prefill"] == (2 * prompt * trunk + 2 * n_layers * d * prompt
                                    * (prompt + 1) + 2 * d * v)
    attended = (prompt + 1) + (prompt + 2) + (prompt + 3)
    assert parts["gpt_decode"] == 2 * 3 * (trunk + d * v) + 4 * n_layers * d * attended
    tf = g["condition_num_latent"] + 2 + 5 + 2 + 4 + 2
    assert parts["gpt_latent"] == 2 * tf * trunk + 2 * n_layers * d * tf * (tf + 1)
    assert "conditioning" not in parts


def test_dit_params_match_the_programs_module():
    from voice_tts_tpu_torch.config import TTSConfig
    from voice_tts_tpu_torch.models.s2mel.s2mel import S2Mel

    import torch
    cfg = tiny_config()
    pcfg = TTSConfig.from_dict(cfg)
    with torch.device("meta"):
        s2 = S2Mel(pcfg.s2mel, pcfg.semantic_codec.hidden_size)
    want = sum(p.numel() for n, p in s2.estimator.named_parameters()
               if not n.startswith("t_embedder"))
    assert costs.params(cfg)["dit_frame"] == want
