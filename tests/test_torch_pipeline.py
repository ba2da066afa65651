"""The port's host pipeline (``runtime.pipeline``) and replay loop
(``io.replay``): the JAX pipeline's contracts, on the CPU."""

import numpy as np
import pytest
import torch

from noetic_slam_tpu_torch.config import CapacityConfig, DlioConfig, ImuConfig
from noetic_slam_tpu_torch.io.replay import replay_dataset
from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu, OdometryPipeline
from noetic_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)


def _cfg(**kw):
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=1024, max_ds_points=512, max_deskew_frames=256,
            max_imu_window=64, max_keyframes=16, max_submap_kf=4),
        **kw)


_NO_CALIB = dict(imu=ImuConfig(calibrate_gyro=False, calibrate_accel=False,
                               gravity_align=False))


def test_pipeline_blocks_without_imu():
    sim = synthetic.make_sim(duration=0.5, n_points=512, seed=3)
    pipe = OdometryPipeline(_cfg(**_NO_CALIB), device="cpu")
    with pytest.raises(NeedMoreImu):
        pipe.process_scan(*sim.scan(0))
    assert pipe.host_syncs == 0


def test_pipeline_skips_empty_scan():
    sim = synthetic.make_sim(duration=0.5, n_points=512, seed=4)
    pipe = OdometryPipeline(_cfg(**_NO_CALIB), device="cpu")
    for i in range(len(sim.imu_stamps)):
        pipe.push_imu(sim.imu_stamps[i], sim.imu_ang[i], sim.imu_acc[i])
    out = pipe.process_scan(0.0, np.full((100, 3), np.nan, np.float32),
                            np.zeros(100))
    assert not bool(out.processed)
    assert pipe.num_skipped == 1 and pipe.num_processed == 0


@pytest.mark.parametrize("with_tsdf", [False, True])
def test_process_scans_matches_per_scan(with_tsdf):
    """``process_scans`` keeps ``process_scan``'s semantics exactly (the
    CPU step is deterministic)."""
    sim = synthetic.make_sim(duration=0.6, n_points=1024, calib_time=3.1,
                             seed=5)
    scans = [sim.scan(s) for s in range(len(sim.scan_stamps))]

    def fed():
        pipe = OdometryPipeline(_cfg(), device="cpu", with_tsdf=with_tsdf)
        for i in range(len(sim.imu_stamps)):
            pipe.push_imu(sim.imu_stamps[i], sim.imu_ang[i], sim.imu_acc[i])
        return pipe

    ref = fed()
    for s in scans:
        ref.process_scan(*s)
    bat = fed()
    bat.process_scans(scans[:4])
    bat.process_scans(scans[4:])
    np.testing.assert_array_equal(bat.flush(), ref.flush())
    assert bat.host_syncs == ref.host_syncs > 0
    if with_tsdf:
        assert torch.equal(bat.tsdf_state.weight, ref.tsdf_state.weight)


def test_process_scans_without_coverage_runs_nothing():
    sim = synthetic.make_sim(duration=0.5, n_points=512, calib_time=3.1,
                             seed=6)
    pipe = OdometryPipeline(_cfg(), device="cpu")
    for i in range(len(sim.imu_stamps)):
        if sim.imu_stamps[i] > 0.15:
            break
        pipe.push_imu(sim.imu_stamps[i], sim.imu_ang[i], sim.imu_acc[i])
    with pytest.raises(NeedMoreImu):
        pipe.process_scans([sim.scan(0), sim.scan(2)])
    assert pipe.headers == [] and pipe.state is not None


class _Seq:
    """A dataset with the MulranDataset interface over a synthetic run
    (no per-point times, like MulRan)."""

    def __init__(self, sim, n):
        self.imu_stamps = sim.imu_stamps
        self.imu_gyro = sim.imu_ang
        self.imu_accel = sim.imu_acc
        self.scans = [sim.scan(i) for i in range(n)]

    def read_scan(self, i):
        return np.c_[self.scans[i][1], np.zeros(len(self.scans[i][1]))]

    def events(self):
        ev = [(t, "imu", i) for i, t in enumerate(self.imu_stamps)]
        ev += [(s[0], "scan", i) for i, s in enumerate(self.scans)]
        return iter(sorted(ev, key=lambda e: (e[0], e[1] == "scan")))


def test_replay_batched_matches_per_scan():
    sim = synthetic.make_sim(duration=0.8, n_points=1024, calib_time=3.1,
                             seed=8)
    ds = _Seq(sim, 8)
    seen = []
    a = OdometryPipeline(_cfg(), device="cpu")
    sa = replay_dataset(ds, a, on_scan=lambda i, out: seen.append(i))
    b = OdometryPipeline(_cfg(), device="cpu")
    sb = replay_dataset(ds, b, batch=3)
    assert sa["n_scans"] == sb["n_scans"] == 8 and seen == list(range(8))
    np.testing.assert_array_equal(a.flush(), b.flush())
    with pytest.raises(ValueError):
        replay_dataset(ds, b, batch=2, on_scan=lambda i, out: None)


def test_entry_points_default_to_the_card():
    """With no ``device`` the pipeline and the state constructors take the
    card, and raise where there is none (no silent CPU)."""
    from noetic_slam_tpu_torch.models.occupancy import init_occupancy
    from noetic_slam_tpu_torch.models.odometry import init_state
    from noetic_slam_tpu_torch.models.tsdf import init_tsdf

    cfg = _cfg().replace(map_backend="occupancy")
    makers = [lambda: OdometryPipeline(cfg).device,
              lambda: OdometryPipeline(cfg, with_tsdf=True).tsdf_state
              .logodds.device,
              lambda: init_state(cfg).p.device,
              lambda: init_tsdf(cfg.tsdf).weight.device,
              lambda: init_occupancy(cfg.occupancy).logodds.device]
    for make in makers:
        if torch.cuda.is_available():
            assert make().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
