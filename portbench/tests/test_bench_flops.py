"""The model FLOPs ``mfu`` counts, against arithmetic done by hand."""
import pytest

from portbench import core
from portbench.yardstick import bounds, flops


def geometry(name):
    return flops.Geometry.from_model(core.load_json(core.BENCH_DIR / "configs" /
                                                    f"{name}.json")["model"])


def test_vit_b_16_colxlip_step():
    g, b = geometry("ViT-B-16-colxlip"), 256
    # vision: 12 blocks of 12 x 768^2 matrix parameters over 197 tokens,
    # 6 FLOPs a parameter and token; attention 12 N^2 D a block; the patch
    # embedding (3 x 16^2 -> 768 over 196 patches); the token head's Linear
    # (768 -> 512 over 196 patches); the pooled projection over one token
    vision = (6 * 12 * 12 * 768 ** 2 * 197 + 12 * 12 * 197 ** 2 * 768
              + 6 * 768 * 768 * 196 + 6 * 768 * 512 * 196 + 6 * 768 * 512)
    text = (6 * 12 * 12 * 512 ** 2 * 77 + 12 * 12 * 77 ** 2 * 512
            + 6 * 512 * 512 * 77 + 6 * 512 * 512)
    maxsim = 3 * 2 * b * b * 77 * 196 * 512
    logits = 3 * 2 * b * b * 512
    assert flops.vision_flops(g) == vision
    assert flops.text_flops(g) == text
    assert flops.loss_flops(g, b) == maxsim + logits
    per_image = flops.train_step_flops(g, b) / b
    assert per_image == pytest.approx(135.71e9, rel=1e-4)
    assert (maxsim + logits) / b == pytest.approx(11.87e9, rel=1e-3)


def test_vit_l_14_colxlip_step():
    g, b = geometry("ViT-L-14-colxlip"), 128
    assert g.v_tokens == 257 and g.patches == 256 and g.v_heads == 16 and g.t_head_dim == 64
    vision = (6 * 24 * 12 * 1024 ** 2 * 257 + 24 * 12 * 257 ** 2 * 1024
              + 6 * 588 * 1024 * 256 + 6 * 1024 * 768 * 256 + 6 * 1024 * 768)
    text = (6 * 12 * 12 * 768 ** 2 * 77 + 12 * 12 * 77 ** 2 * 768
            + 6 * 768 * 768 * 77 + 6 * 768 * 768)
    loss = 3 * 2 * b * b * 77 * 256 * 768 + 3 * 2 * b * b * 768
    assert flops.train_step_flops(g, b) == b * (vision + text) + loss
    assert flops.train_step_flops(g, b) / b == pytest.approx(539.08e9, rel=1e-4)


def test_kernel_bounds_count_each_launch():
    g, b = geometry("ViT-B-16-colxlip"), 256
    got = bounds.train_step_bounds(g, b, "bfloat16")
    assert len(got["attention_fwd"]) == len(got["attention_bwd"]) == 24
    assert len(got["mlp_fwd"]) == 24 and len(got["maxsim_fwd"]) == 1
    assert len(got["layernorm_fwd"]) == 2 * 12 + 2 + 2 * 12 + 1 + 4
    # the vision attention forward at N = 197 is bound by its bytes: packed
    # qkv read and the output written, 4 B N W bf16 elements at 3.35 TB/s,
    # against 4 B H N^2 D operations at 989 TFLOP/s
    assert got["attention_fwd"][0] == pytest.approx(4 * b * 197 * 768 * 2 / 3.35e12)
    assert 4 * b * 12 * 197 ** 2 * 64 / 989e12 < got["attention_fwd"][0]
    # the text one is causal: N (N + 1) / 2 pairs
    assert got["attention_fwd"][-1] == pytest.approx(
        max(4 * b * 77 * 512 * 2 / 3.35e12, 4 * b * 77 * 78 / 2 * 512 / 989e12))
