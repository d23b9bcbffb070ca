"""The profiler arithmetic of ``chip_smoke.py``, on the CPU: device time
per call from two profiles (one call, ``iters`` calls), counted per
kernel name, and never a low number from a profile that dropped events;
and the ptxas report it prints. JAX-free, like the script."""
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
