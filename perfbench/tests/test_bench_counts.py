"""The operation and byte counts against counts made by hand."""

import pytest

from perfbench import counts

N, E = 232965, 23526073
GCN = {"model": "gcn", "reference": "gcn", "layers": [602, 256, 41]}
GAT = {"model": "gat", "reference": "gat", "layers": [602, 64, 41],
       "heads": 4}


def test_gcn_step_flops_by_hand():
    c = counts.step_counts(GCN, N, E, train=True)
    # GEMMs: forward 2N(602*256 + 256*41), dW of both, dX of layer 2 only
    gemm = 2 * N * (602 * 256 * 2 + 256 * 41 * 3)
    # sums: an add per gathered element, forward and transposed, H=256, 41
    sums = 2 * E * (256 + 41)
    assert c["gemm_flops"] == gemm
    assert c["sum_flops"] == sums
    assert c["flops"] == pytest.approx(172.2e9, rel=1e-3)
    assert gemm == pytest.approx(158.3e9, rel=1e-3)
    assert sums == pytest.approx(14.0e9, rel=3e-3)


def test_gcn_sum_least_time_by_hand():
    # bytes bound each: x in and out in fp32, row_ptr int64, col_idx int32
    def one(h):
        return (2 * N * h * 4 + (N + 1) * 8 + E * 4) / 3.35e12
    want = 2 * one(256) + 2 * one(41)
    c = counts.step_counts(GCN, N, E, train=True)
    assert c["sum_least_s"] == pytest.approx(want, rel=1e-12)
    assert c["sum_least_s"] == pytest.approx(0.445e-3, rel=2e-3)
    fwd = counts.step_counts(GCN, N, E, train=False)
    assert fwd["sum_least_s"] == pytest.approx(one(256) + one(41))


def test_gat_step_flops_by_hand():
    c = counts.step_counts(GAT, N, E, train=True)
    gemm = 2 * N * (602 * 256 * 2 + 256 * 41 * 3)
    assert c["gemm_flops"] == gemm
    att = 0
    for k, f in ((4, 64), (1, 41)):
        h = k * f
        att += 2 * N * h * 2                       # source and dest dots
        att += E * k * (2 * f + 5) + N * h         # forward
        att += E * k * (4 * f + 5)                 # backward
    assert c["gat_flops"] == att
    assert c["flops"] == pytest.approx(200e9, rel=0.03)
    assert c["sum_flops"] == 0 and c["sum_least_s"] == 0


def test_least_time_takes_the_larger_bound():
    assert counts.least_s(67e12, 0) == pytest.approx(1.0)
    assert counts.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_s(67e9, 3.35e12) == pytest.approx(1.0)


def test_kernel_groups_by_name():
    tr = {"kernels": {"void sum_rows<float, 4>(long const*)": 1.0,
                      "void stage_kernel<8>(float const*)": 0.5,
                      "void stage_kernel_f32(float const*)": 0.25,
                      "void gat_fwd_rows<2, 4>(FwdArgs)": 2.0,
                      "sm90_xmma_gemm_f32f32_f32f32_f32_nn": 3.0,
                      "void splitKreduce_kernel<32, 16>": 0.125,
                      "void at::native::elementwise_kernel": 9.0}}
    assert counts.kernel_seconds(tr, counts.SUM_KERNELS) == 1.5
    assert counts.kernel_seconds(tr, counts.GAT_KERNELS) == 2.25
    assert counts.kernel_seconds(tr, counts.GEMM_KERNELS) == 3.125
