"""The chain's roofline counts the work of the valid granules of the streams,
whatever the launch shape, and no padding."""

import numpy as np
import pytest

from benchmark import roofline
from benchmark.gen import traffic
from benchmark.reference import decode as reference
from benchmark.run import load_metric

CFG = {"lowpass_hz": {"192": 19500}, "short_share": 0.1, "mixed_share": 0.04,
       "ms_share": 0.8, "loudness_rms": 0.012,
       "pool": {"runs_per_bitrate": 3, "frames_per_run": 10}}


def _recount(stream):
    """The stream's work counted again from its parsed frames."""
    frames = reference._frames(stream.data, 0, None)
    ops = nbytes = 0.0
    for f in frames:
        si, md = f.side_info, f.main_data
        short = np.array([[si.win_switch_flag[g][c] == 1 and si.block_type[g][c] == 2
                           for c in range(2)] for g in range(2)])
        mixed = short & (np.array(si.mixed_block_flag) == 1)
        ms = np.array([f.header.use_ms_stereo] * 2)
        ops += roofline.granule_ops(md.is_, short, mixed, ms).sum()
        nbytes += roofline.granule_bytes(np.array(si.part2_3_length)).sum()
    return len(frames), ops, nbytes


def test_long_granule_count():
    is_ = np.zeros((1, 2, 576), np.int32)
    is_[0, 0, :100] = 3
    is_[0, 1, :40] = -1
    ops = roofline.granule_ops(is_, np.zeros((1, 2), bool), np.zeros((1, 2), bool),
                               np.array([True]))
    fixed = 31 * 48 + 32 * 282 + 18 * 289 + 576 * 31
    assert ops.tolist() == [[100 + 100 + fixed, 40 + 100 + fixed]]


@pytest.mark.parametrize("n_frames", [7, 10, 23])
def test_stream_work_is_its_frames_work(n_frames):
    rng = np.random.default_rng(n_frames)
    pool = traffic.make_pool(CFG, rng, [192])
    s = traffic.compose(rng, pool[192], 192, n_frames)  # the last run cut
    frames, ops, nbytes = _recount(s)
    assert frames == n_frames
    assert s.ops == pytest.approx(ops, rel=1e-12)
    assert s.nbytes == pytest.approx(nbytes, rel=1e-12)


def test_metric_reads_the_streams_work_over_the_chain_kernels_time():
    read = load_metric("chain_roofline_pct.corpus")
    trace = {"by_name": {"chain_kernel<3, 4>": {"us": 600.0}, "chain_kernel_run1<0, 1>":
                         {"us": 400.0}, "Memcpy HtoD": {"us": 5000.0}}}
    r = {"chain_ops": 67e9, "chain_bytes": 1e6, "trace": trace}
    assert read(r) == pytest.approx(100.0)  # 1 ms of work in 1 ms of chain kernels
    # the same work in two batches, or one: the same count
    assert read({**r, "chain_ops": 33.5e9 + 33.5e9}) == pytest.approx(100.0)
    assert read({**r, "trace": None}) is None
    assert read({**r, "trace": {"by_name": {}}}) is None
