"""The yardstick's counts against hand-computed values and against
``torch.utils.flop_counter`` run on the plain reference at small shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, harness
from benchmark.reference import conformer, hifigan, s3tokenizer, unet
from benchmark.reference import t3 as rt3

LLAMA = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
         "num_attention_heads": 2, "num_key_value_heads": 2, "head_dim": 32}


def _count(fn):
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


def _tree(shapes):
    g = torch.Generator().manual_seed(0)
    return {k: _tree(v) if isinstance(v, dict) else torch.randn(v, generator=g) * 0.1
            for k, v in shapes.items()}


def test_k1a_bytes_and_flops_by_hand():
    # two CFG rows of one text: prefix 34 + 6 slots, gap_end 34 + 8, write_pos 34 + 8 + 2 + 3
    prefix = counts.t3_prefix_lens([6])
    n_bytes, flops = counts.k1a_step(prefix, 42, 47, heads=2, head_dim=4)
    live = 2 * (40 + 5)  # each row: 40 prefix slots and slots 42..46
    assert n_bytes == 2 * live * 2 * 4 * 2 + 4 * 2 * 2 * 4 * 2 + 2 * 4
    assert flops == 4 * (live + 2) * 2 * 4


def test_k1cd_splits_int8_and_tail_slots():
    prefix = counts.t3_prefix_lens([6])  # 40 and 40
    # write_pos 47: merge_base 40; int8 slots [0, 40) of the prefix; tail slots 42..46
    n_bytes, flops = counts.k1cd_step(prefix, 42, 47, heads=1, head_dim=2)
    live8, tail = 2 * 40, 2 * 5
    assert n_bytes == 2 * 1 * 2 * (live8 + 2 * tail) + 2 * 1 * 4 * live8 + 4 * 2 * 1 * 2 * 2 + 2 * 4
    assert flops == 4 * (live8 + tail + 2) * 1 * 2


def test_k1_call_bounds_follow_the_decode_schedule():
    llama = dict(LLAMA, num_hidden_layers=3)
    b = counts.k1_call_bounds([5, 7], 32, steps=4, llama=llama, int8=False)
    assert len(b) == 3 * 3  # (steps - 1) decode steps, one launch a layer
    assert b[0] == b[2] < b[3] < b[6]


def test_k3_launch_by_hand():
    est = {"num_heads": 2, "attention_head_dim": 8}
    n_bytes, flops = counts.k3_launch([10, 6], est, padded=128)
    assert flops == 2 * (4 * 100 * 16 + 4 * 36 * 16)
    assert n_bytes == 2 * (4 * 10 * 16 * 2 + 4 * 6 * 16 * 2) + 4 * 128 * 4


def test_llama_flops_match_the_reference_forward():
    cfg = rt3.LlamaConfig(**LLAMA)
    c, f, n_l = 64, 96, 2
    p = {"layers": _tree({"input_ln": {"scale": (n_l, c)}, "post_ln": {"scale": (n_l, c)},
                          "q": {"w": (n_l, c, c)}, "k": {"w": (n_l, c, c)},
                          "v": {"w": (n_l, c, c)}, "o": {"w": (n_l, c, c)},
                          "gate_up": {"w": (n_l, 2 * f, c)}, "down": {"w": (n_l, c, f)}}),
         "final_ln": {"scale": torch.ones(c)}}
    s = 20
    got = _count(lambda: rt3.llama_forward(p, cfg, torch.randn(1, s, c)))
    # the reference's dense attention computes every (query, key) pair
    assert got == counts.llama_token_flops(LLAMA) * s + 4 * n_l * c * s * s


def test_t3_flops_count_prefill_and_decode():
    n_l, hd, c, v = 2, 64, 64, 100
    one = counts.t3_flops([5], [3], LLAMA, v)
    p0 = 34 + 5 + 2
    keys = p0 * (p0 + 1) // 2 + (p0 + 1) + (p0 + 2)
    want = 2 * (counts.llama_token_flops(LLAMA) * (p0 + 2) + 4 * n_l * hd * keys
                + 2 * c * v * 3)
    assert one == want


def _unet_cfg():
    return unet.UNetConfig(channels=32, n_blocks=1, num_mid_blocks=2, num_heads=2,
                           attention_head_dim=16)




@pytest.mark.parametrize("t", [16, 40])
def test_unet_flops_within_the_counted(t):
    from chatterbox_tpu_torch import weights as pw

    cfg = _unet_cfg()
    p = pw._init_unet(pw._Init(0, "cpu", torch.float32), cfg)
    x = torch.randn(1, t, 80)
    got = _count(lambda: unet.unet_forward(p, cfg, x, x, torch.randn(1, 80), x,
                                           torch.rand(1)))
    want = counts.unet_flops(t, harness_dict(cfg))
    # the counter also sees the time MLP (once a row, not a frame)
    assert want <= got <= want * 1.05


def harness_dict(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("t", [12, 30])
def test_conformer_flops_within_the_counted(t):
    from chatterbox_tpu_torch import weights as pw

    cfg = conformer.ConformerConfig(input_size=64, output_size=64, attention_heads=2,
                                    linear_units=96, num_blocks=2, num_up_blocks=1)
    p = pw._init_conformer(pw._Init(0, "cpu", torch.float32), cfg)
    got = _count(lambda: conformer.upsample_conformer_encoder(p, torch.randn(1, t, 64), cfg))
    want = counts.conformer_flops(t, harness_dict(cfg))
    # the dense rel-pos term computes (T, 2T - 1) scores where T x T are needed
    assert want <= got <= want * 1.10


def test_hift_flops_within_the_counted():
    from chatterbox_tpu_torch import weights as pw

    cfg = hifigan.HiFTConfig(base_channels=32, f0_cond_channels=32)
    p = pw.init_hift(cfg, 0, "cpu")
    t = 10
    h = cfg.nb_harmonics + 1
    got = _count(lambda: hifigan.hift_generate(p, cfg, torch.randn(1, t, 80), torch.zeros(1, h),
                                               torch.randn(1, h, t * cfg.upsample_total)))
    want = counts.hift_flops(t, harness_dict(cfg))
    # the counter also sees the STFT and iSTFT, written as convolutions: a
    # fixed cost a sample, 7% of these 32 channels (0.1% of the published 512)
    assert want <= got <= want * 1.10


def test_s3tok_flops_within_the_counted():
    from chatterbox_tpu_torch import weights as pw

    cfg = s3tokenizer.S3TokenizerConfig(n_state=64, n_head=4, n_layer=2)
    p = pw.init_s3tokenizer(cfg, 0, "cpu")
    t = 80
    got = _count(lambda: s3tokenizer.s3_encode_mels(p, cfg, torch.randn(1, t, 128)))
    want = counts.s3tok_flops(t, harness_dict(cfg))
    assert want <= got <= want * 1.02


def test_bounds_take_the_larger_side():
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 989e12) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)
    assert harness.build is not None
