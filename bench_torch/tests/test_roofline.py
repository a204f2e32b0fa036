"""The yardstick's counts against shapes worked by hand: kernels B and E at
2^18 points of 16 levels, A and D at 2^18 rows, the MLP operations of one
sample."""

import json
import os

import pytest

from bench_torch import roofline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 1 << 18


def model(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)["run"]["model"]


@pytest.fixture(params=["ngp_quad", "ngp_xor"])
def ngp(request):
    return model(request.param)


def test_mlp_operations_of_a_sample(ngp):
    assert roofline.mlp_flops_per_sample(ngp) == 2 * (32 * 64 + 64 * 16 + 18 * 64 + 64 * 64 + 64 * 3) == 17024
    assert roofline.mlp_flops_per_sample(ngp, chains=(0,)) == 2 * (32 * 64 + 64 * 16)


def test_hash_encode_at_2e18_points(ngp):
    # xyz 12 B and 16 levels x 2 f32 features out a point; 1000 entries of 2 f32 read
    nbytes, flops = roofline.hash_fwd(ngp, P, 1000)
    assert nbytes == P * (12 + 128) + 1000 * 8
    assert flops == P * 16 * 8 * 2 * 2


def test_hash_encode_bwd_at_2e18_points(ngp):
    # xyz and g in, the whole 16 x 2^19 x 2 f32 table gradient out
    nbytes, flops = roofline.hash_bwd(ngp, P)
    assert nbytes == P * (12 + 128) + 16 * 2**19 * 2 * 4
    assert flops == P * 16 * 8 * 2 * 2


def test_fused_mlp_fwd_at_2e18_rows(ngp):
    weights = 32 * 64 + 64 * 16 + 18 * 64 + 64 * 64 + 64 * 3
    nbytes, flops = roofline.mlp_fwd(ngp, P)
    assert nbytes == P * ((32 + 16) + (18 + 3)) * 4 + weights * 4
    assert flops == 2 * P * weights
    # the training build also writes the bf16 hidden pre-activations: 64 + 128 a row
    nbytes_pre, _ = roofline.mlp_fwd(ngp, P, save_pre=True)
    assert nbytes_pre - nbytes == P * (64 + 128) * 2


def test_fused_mlp_bwd_at_2e18_rows(ngp):
    geo = P * (2 * 32 * 4 + 16 * 4 + 64 * 2) + 2 * (32 * 64 + 64 * 16) * 4
    rad = P * (2 * 18 * 4 + 3 * 4 + 128 * 2) + 2 * (18 * 64 + 64 * 64 + 64 * 3) * 4
    nbytes, flops = roofline.mlp_bwd(ngp, P)
    assert nbytes == geo + rad
    assert flops == 4 * P * 8512


def test_bound_is_the_larger_time():
    assert roofline.bound_s(3.35e12, 0.0, roofline.BF16_FLOP_S) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 989e12, roofline.BF16_FLOP_S) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12, roofline.F32_FLOP_S) == pytest.approx(2.0)
