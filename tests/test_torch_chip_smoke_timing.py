"""The profiler arithmetic of ``chip_smoke.py``, on the CPU: device time
per call from two profiles (one call, ``iters`` calls), counted per
kernel name, or from one profile of ``iters`` calls against a launcher's
own launch counter, and never a low number from a profile that dropped
events; and the ptxas report it prints. JAX-free, like the script."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_one_kernel_per_call():
    one = [(41.0, 1, "flash_kernel")]
    many = [(50 * 40.0, 50, "flash_kernel")]
    ms, dropped = chip_smoke.per_call_device_ms(one, many, iters=50)
    assert dropped == {} and ms == pytest.approx(0.040)


def test_several_kernels_per_call():
    """Each name's time over its own launches, times its launches a call:
    a fill and a copy once a call, the scan twice."""
    one = [(2100.0, 2, "mlstm_kernel"), (9.0, 1, "fill"), (3.0, 1, "Memcpy DtoD")]
    many = [(10 * 2 * 1000.0, 20, "mlstm_kernel"), (10 * 8.0, 10, "fill"),
            (10 * 2.0, 10, "Memcpy DtoD")]
    ms, dropped = chip_smoke.per_call_device_ms(one, many, iters=10)
    assert dropped == {}
    assert ms == pytest.approx((2 * 1000.0 + 8.0 + 2.0) / 1e3)


@pytest.mark.parametrize("many,dropped", [
    ([(19 * 1000.0, 19, "mlstm_kernel"), (80.0, 10, "fill")],    # a launch lost
     {"mlstm_kernel": (19, 20)}),
    ([(20 * 1000.0, 20, "mlstm_kernel")], {"fill": (0, 10)}),   # a name lost
    ([(20 * 1000.0, 20, "mlstm_kernel"), (80.0, 10, "fill"),
      (5.0, 1, "stray")], {"stray": (1, 0)}),                   # a name gained
])
def test_a_dropped_event_gives_none_and_names_it(many, dropped):
    """The old arithmetic divided the total by the iterations, so a lost
    launch read as a shorter call; now the profile is reported as
    dropped, with its counts, and no time is given."""
    one = [(2000.0, 2, "mlstm_kernel"), (8.0, 1, "fill")]
    assert chip_smoke.per_call_device_ms(one, many, iters=10) == (None, dropped)


def test_a_one_call_profile_that_lost_its_launch_gives_none():
    """Seen on the card: the one-call profile recorded nothing and the
    50-call one 49 launches."""
    many = [(49 * 55.0, 49, "flash_kernel")]
    assert chip_smoke.per_call_device_ms([], many, iters=50) == (
        None, {"flash_kernel": (49, 0)})


def test_no_device_time_gives_none():
    assert chip_smoke.per_call_device_ms([], [], iters=10) == (None, {})


def test_counted_profile_takes_its_launches_from_the_counter():
    """The training backwards' one-call profile records no launch at all:
    their launches come from the launcher's counter over the profile of
    ``iters`` calls, and the call's time is the profile's total over
    ``iters``, a transpose copy and the kernel alike."""
    many = [(5 * 5500.0, 5, "(anonymous namespace)::slstm_bwd_kernel<2>(float"),
            (5 * 40.0, 5, "elementwise_kernel")]
    ms, dropped = chip_smoke.counted_device_ms(many, 5, ("slstm_bwd_kernel",), 5)
    assert dropped == {} and ms == pytest.approx(5.540)
    # a path of two kernels a call, counted as two launches a call
    many = [(10 * 300.0, 10, "dq_kernel<256>"), (10 * 900.0, 10, "dkv_kernel<256>")]
    ms, dropped = chip_smoke.counted_device_ms(
        many, 10, ("fused_kernel", "dq_kernel", "dkv_kernel"), 20)
    assert dropped == {} and ms == pytest.approx(1.2)


@pytest.mark.parametrize("many,launched,dropped", [
    # a launch lost: the counter saw 10
    ([(9 * 1300.0, 9, "fused_kernel")], 10,
     {"fused_kernel+dq_kernel+dkv_kernel": (9, 10), "fused_kernel": (9, 10)}),
    # the kernel's launches as counted, another name's lost
    ([(10 * 1300.0, 10, "fused_kernel"), (7.0, 7, "memset")], 10, {"memset": (7, 10)}),
    # no counter (a library call): each name a whole number a call
    ([(20 * 100.0, 20, "fmha_bwd"), (11 * 5.0, 11, "fill")], None, {"fill": (11, 20)}),
])
def test_counted_profile_that_dropped_a_launch_gives_none(many, launched, dropped):
    assert chip_smoke.counted_device_ms(
        many, 10, ("fused_kernel", "dq_kernel", "dkv_kernel"), launched) == (None, dropped)


def test_counted_profile_with_no_device_time_gives_none():
    assert chip_smoke.counted_device_ms([], 10, ("fused_kernel",), 0) == (None, {})


def test_flash_bwd_bound_follows_the_engine():
    """At S <= 64 the fused kernel runs the five products in 3xTF32 on the
    tensor cores (495 / 3 TFLOP/s), above it the SIMT kernels in f32 (67):
    at the encoder's (1024, 4, 64, 256) the bytes bound it either way."""
    mem = 3.35e12
    ms, by = chip_smoke.flash_bwd_bound_ms(4096, 64, 256, mem)
    assert by == "bytes" and ms == pytest.approx(4096 * 64 * (8 * 256 + 1) * 4 / mem * 1e3)
    ops = 4096 * 10 * 64 * 64 * 256
    assert ops * 3 / chip_smoke.TF32_OPS_PER_S * 1e3 < ms
    _, by = chip_smoke.flash_bwd_bound_ms(64, 1024, 256, mem)  # SIMT: operations
    assert by == "operations"


def test_slstm_bwd_bound_follows_the_engine():
    """The BPTT products run in 3xTF32 on the tensor cores: at the stacked
    training shape their 137 GFLOP take 0.83 ms at 495 / 3 TFLOP/s, under
    the 0.98 ms of its 3.29 GB, so the bytes bound it (on SIMT f32 the
    operations did, 2.05 ms)."""
    ms, by = chip_smoke.slstm_bwd_bound_ms(1024, 16, 4, 64, 256, 3.35e12)
    nbytes = 1024 * 4 * 64 * 256 * 12 * 4 + 16 * 4 * 256 * 1024 * 4
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    ops = 1024 * 4 * 64 * 2 * 256 * 1024
    assert 3 * ops / chip_smoke.TF32_OPS_PER_S * 1e3 == pytest.approx(0.833, abs=1e-3)


def test_ptxas_summary_reads_registers_and_spills():
    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelIfEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelIfEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 222 registers, used 1 barriers
ptxas info    : Compile time = 1679.055 ms
ptxas info    : Function properties for _Z5stepsv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
"""
    assert chip_smoke.ptxas_summary(report) == [
        ("_Z6kernelIfEvv", "222 registers; 0 bytes stack frame, 0 bytes "
                           "spill stores, 0 bytes spill loads")]


def _fake_profiles(monkeypatch, profiles):
    """device_kernels replaced by a run of ``run`` that returns the next
    of ``profiles``."""
    profiles = iter(profiles)

    def fake(run):
        run()
        return next(profiles)

    monkeypatch.setattr(chip_smoke, "device_kernels", fake)


class _Launcher:
    launches = 0


def _launch():
    _Launcher.launches += 1


def test_counted_ms_profiles_again_while_a_launch_is_lost(monkeypatch, capsys):
    _fake_profiles(monkeypatch, [[(900.0, 9, "fused_kernel")],
                                 [(1000.0, 10, "fused_kernel")]])
    ms = chip_smoke.counted_ms(_launch, iters=10, launcher=_Launcher,
                               symbols=("fused_kernel",))
    assert ms == pytest.approx(0.1)
    assert "dropped" not in capsys.readouterr().out


def test_counted_ms_gives_none_after_its_profiles_all_lose_one(monkeypatch, capsys):
    _fake_profiles(monkeypatch, [[(900.0, 9, "fused_kernel")]]
                   * chip_smoke.COUNTED_PROFILES)
    assert chip_smoke.counted_ms(_launch, iters=10, label="flash", launcher=_Launcher,
                                 symbols=("fused_kernel",)) is None
    assert "profiler dropped events (flash)" in capsys.readouterr().out


def test_counted_ms_without_a_launcher_needs_whole_launches_a_call(monkeypatch):
    """A library call (no counter): each name a whole number a call."""
    _fake_profiles(monkeypatch, [[(2000.0, 20, "fmha_bwd"), (50.0, 10, "fill")]])
    assert chip_smoke.counted_ms(lambda: None, iters=10) == pytest.approx(0.205)


def test_mlstm_bwd_flops():
    """The backward's operation count: one chunk has no carried state
    (only the scores, the in-chunk sums and the row terms); two chunks
    add each sweep's carried-state products once and its state update
    once; xlstm-350m's training shape gives the source's 7.16 GFLOP."""
    one = chip_smoke.mlstm_bwd_flops(1, 1, 64, 8, 4, True)
    assert one == 64 * 65 * (5 + 8) + 64 * 65 * (16 + 4) + 4 * 64 * 12 + 4 * 64 * 8
    two = chip_smoke.mlstm_bwd_flops(1, 1, 128, 8, 4, False)
    assert two == (2 * 64 * 65 * (4 + 8) + 2 * 64 * 65 * 20
                   + 128 * (4 * 4 * 8 + 2 * 8 * 4) + 4 * 128 * 8)
    ragged = chip_smoke.mlstm_bwd_flops(1, 1, 70, 8, 4, False)
    assert ragged == ((64 * 65 + 6 * 7) * 32 + (6 + 64) * (4 * 4 * 8 + 2 * 8 * 4)
                      + 4 * 70 * 8)
    assert round(chip_smoke.mlstm_bwd_flops(8, 4, 128, 512, 512, True) / 1e9, 2) == 7.16


def test_kernels_of_scales_a_launcher_counter():
    class Launcher:
        launches = 5

    scaled = chip_smoke._KernelsOf(Launcher, 3)
    assert scaled.launches == 15
    Launcher.launches = 6
    assert scaled.launches == 18
