"""The frozen formulas against hand-computed values and against the
program's own copies at the cells' shapes."""
import pytest

from portbench import harness, rooflines, work


def test_ssd_work_at_mamba2s_micro_batch():
    ops, nbytes = work.ssd_work(2, 2048, 48, 64, 1, 128, 128)
    assert ops == 7_931_953_152
    assert nbytes == 108_789_952


def test_ssd_work_by_hand_on_two_chunks():
    # B=1, S=4, H=1, P=1, G=1, N=1, chunk 2: two chunks of 2 live tokens,
    # 3 causal pairs each; state terms 2 (first) and 4 (second)
    ops, nbytes = work.ssd_work(1, 4, 1, 1, 1, 1, 2)
    assert ops == 2 * (3 + 3 + 2) + 2 * (3 + 3 + 4)
    assert nbytes == 4 * (2 * 4 + 4 + 1 + 2 * 4 + 1)


def test_attention_bwd_work_counts_causal_pairs():
    assert work.live_pairs(4, 4, True, 0, 0) == 10
    ops, nbytes = work.attention_bwd_work(1, 4, 4, 1, 1, 2, 2, True, 0, 0,
                                          2)
    assert ops == 2 * 10 * (3 * 2 + 2 * 2)
    assert nbytes == 2 * (4 * (2 + 4 + 2) + 2 * 4 * 4) + 4 * 4


@pytest.mark.parametrize("shape", [(2, 2048, 48, 64, 1, 128, 128),
                                   (2, 2048, 64, 64, 1, 64, 128),
                                   (1, 300, 3, 16, 1, 16, 128)])
def test_frozen_formulas_equal_the_programs(shape):
    from repro_torch.kernels import work as program
    assert work.ssd_work(*shape) == program.ssd_work(*shape)
    assert work.ssd_bwd_work(*shape, False) == \
        program.ssd_bwd_work(*shape, False)
    assert work.ssd_bwd_recompute_ops(*shape) == \
        program.ssd_bwd_recompute_ops(*shape)
    args = (shape[0], shape[1], shape[1], 32, 32, 64, 64, True, 0, 0, 2)
    assert work.attention_bwd_work(*args) == \
        program.attention_bwd_work(*args)


def test_train_flops_per_token_of_mamba2():
    cfg = harness.load_json("configs", "mamba2-780m")
    d, di, N, H = 1536, 3072, 128, 48
    mm = 48 * (d * (2 * di + 2 * N + H) + di * d) + 50280 * d
    fwd = work.ssd_work(2, 2048, H, 64, 1, N, 128)[0]
    bwd = work.ssd_bwd_work(2, 2048, H, 64, 1, N, 128, False)[0] \
        - work.ssd_bwd_recompute_ops(2, 2048, H, 64, 1, N, 128)
    want = 6.0 * mm + 48 * (fwd + bwd) / 4096
    assert work.train_flops_per_token(cfg, 2, 2048) == pytest.approx(want)


def test_train_flops_per_token_of_the_hybrid_counts_six_shared_calls():
    from conftest import HYBRID
    cfg = HYBRID
    no_shared = dict(cfg, arch_type="ssm", tie_embeddings=False)
    base = work.train_flops_per_token(no_shared, 2, 2048)
    shared = 6.0 * (4 * 2048 * 2048 + 3 * 2048 * 8192) \
        + 2.0 * 2 * 32 * work.live_pairs(2048, 2048, True, 0, 0) * 128 \
        * (1 + 2) / 4096
    assert work.train_flops_per_token(cfg, 2, 2048) == \
        pytest.approx(base + 6 * shared)


def test_roofline_share_from_calls_and_trace():
    from types import SimpleNamespace
    cell = harness.load_json("workloads", "mamba2-780m.managed")
    cfg = harness.load_json("configs", "mamba2-780m")
    peaks = {"tf32_flops": 495e12, "bf16_flops": 989e12,
             "hbm_bytes_per_s": 3.35e12}
    ops, nbytes = work.ssd_work(2, 2048, 48, 64, 1, 128, 128)
    least = max(ops / 495e12, nbytes / 3.35e12)
    tr = SimpleNamespace(kernels={
        "void (anonymous namespace)::ssd_y_kernel<64>(P)": (0.008, 10),
        "void (anonymous namespace)::ssd_cb_kernel<64>(P)": (0.002, 10),
        "void at::native::reduce_kernel<512>(R)": (5.0, 3)})
    run = SimpleNamespace(cfg=cfg, cell=cell, peaks=peaks, trace=tr,
                          launches={"ssd_scan": 10})
    assert rooflines.share(run, "ssd_scan", rooflines.ssd_scan) == \
        pytest.approx(100 * 10 * least / 0.01)
    assert rooflines.share(run, "flash_attention_bwd",
                           rooflines.flash_attention_bwd) is None
    run.launches = {}
    assert rooflines.share(run, "ssd_scan", rooflines.ssd_scan) is None
