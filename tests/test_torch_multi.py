"""The port's multi-sequence runtime (``runtime.multi``, ``parallel.batch``)
on the CPU: the cases of tests/test_multi_pipeline.py with two devices
(``devices=["cpu", "cpu"]``) in place of the 2-device mesh, each run held
EXACTLY to the port's one-sequence ``OdometryPipeline`` (the batched step
is that step, sequence by sequence); an idle round leaves every state
field bitwise as it was apart from ``total_steps``; checkpoints resume
bitwise and cross between the packages in both directions; the port's run
stays within the replay tolerance (5 cm per pose, stamps to 1e-6) of the
JAX ``MultiSequencePipeline`` on the same feeds, unsharded; and ``cli
batch --device cpu`` against the JAX ``cli batch``."""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from noetic_slam_tpu.runtime import multi as jmulti
from noetic_slam_tpu.utils import synthetic as jsyn
from noetic_slam_tpu_torch.config import (
    CapacityConfig,
    DlioConfig,
    KeyframeConfig,
)
from noetic_slam_tpu_torch.parallel import batch as pbatch
from noetic_slam_tpu_torch.runtime.multi import (
    ArrayFeed,
    MultiSequencePipeline,
    run_lockstep,
)
from noetic_slam_tpu_torch.runtime.pipeline import NeedMoreImu, OdometryPipeline
from noetic_slam_tpu_torch.utils import synthetic
from tests.torch_parity import jax_cfg

torch.set_num_threads(1)

POSE_TOL = 0.05          # [m] per pose over a replay (ROADMAP Rules)
TWO = ["cpu", "cpu"]
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mulran_mini")


def _cfg():
    """tests/test_multi_pipeline.py:20-27."""
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=256,
            max_imu_window=64, max_keyframes=32, max_submap_kf=8,
            max_trajectory=128),
        keyframe=KeyframeConfig(thresh_dist=0.5),
        adaptive=False)


def _feed(sim_scans, max_scans=None, cls=ArrayFeed):
    """Feed over pre-generated scans (``Sim.scan`` draws afresh at every
    call, so every run shares one list)."""
    sim, scans = sim_scans
    return cls(sim.imu_stamps, sim.imu_ang, sim.imu_acc, sim.scan_stamps,
               lambda i: scans[i], max_scans=max_scans)


def _run_single(cfg, sim_scans, max_scans=None):
    """Reference: one sequence through its own OdometryPipeline."""
    pipe = OdometryPipeline(cfg, device="cpu")
    feed = _feed(sim_scans, max_scans=max_scans)
    while True:
        item = feed.next_ready_scan(pipe, pipe.push_imu)
        if item is None:
            break
        pipe.process_scan(*item)
    return pipe.flush()


def _puller(mp, feeds):
    def pull(i):
        return feeds[i].next_ready_scan(
            mp.frontends[i], lambda s, a, c, i=i: mp.push_imu(i, s, a, c))
    return pull


def _same(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def sims():
    """tests/test_multi_pipeline.py's sequences (seeds 3 and 9)."""
    out = []
    for s in (3, 9):
        sim = synthetic.make_sim(duration=1.2, n_points=2048, calib_time=3.1,
                                 seed=s)
        out.append((sim, [sim.scan(i)
                          for i in range(len(sim.scan_stamps))]))
    return out


@pytest.fixture(scope="module")
def solo(sims):
    return [_run_single(_cfg(), s) for s in sims]


@pytest.fixture(scope="module")
def full(sims):
    """The port's uninterrupted lockstep run over both sequences."""
    mp = MultiSequencePipeline(_cfg(), n_seq=2, devices=TWO)
    return run_lockstep(mp, [_feed(s) for s in sims])


def test_lockstep_parity_two_devices(sims, solo, full):
    """Equal-length lockstep over two devices == the one-sequence runs,
    exactly; sequence i on the i-th device."""
    mp = MultiSequencePipeline(_cfg(), n_seq=2, devices=TWO)
    assert [str(d) for d in mp.seq_device] == TWO
    assert all(len(r) > 4 for r in solo)
    for r, o in zip(solo, full):
        _same(o, r)
    for (sim, _), o in zip(sims, full):
        ate = synthetic.ate_rmse(o[:, 0], o[:, 1:4], sim.gt_stamps,
                                 sim.gt_pos)
        assert ate < 0.08, ate


def test_devices_must_divide_sequences():
    with pytest.raises(ValueError, match="not divisible"):
        MultiSequencePipeline(_cfg(), n_seq=3, devices=TWO)
    mp = MultiSequencePipeline(_cfg(), n_seq=4, devices=["cpu", "meta"])
    assert [d.type for d in mp.seq_device] == ["cpu", "cpu", "meta", "meta"]


def test_lockstep_unequal_lengths(sims, solo):
    """One sequence exhausts early and idles: its trajectory is its
    truncated solo run; the longer sequence is unaffected."""
    cfg = _cfg()
    short = 5
    ref_short = _run_single(cfg, sims[1], max_scans=short)
    mp = MultiSequencePipeline(cfg, n_seq=2, devices=["cpu"])
    out = run_lockstep(mp, [_feed(sims[0]), _feed(sims[1], max_scans=short)])
    _same(out[0], solo[0])
    _same(out[1], ref_short)
    st = mp.states[1]
    assert int(st.total_steps) == mp.rounds > int(st.num_scans) == short


def test_idle_round_is_exact_noop(sims):
    """An idle round (all sequences stalled) leaves every state field
    bitwise unchanged except the step counter."""
    mp = MultiSequencePipeline(_cfg(), n_seq=2, devices=TWO)
    pull = _puller(mp, [_feed(s) for s in sims])
    for _ in range(4):                     # a few real rounds first
        mp.step_round([pull(0), pull(1)])
    before = [[x.clone() for x in st] for st in mp.states]
    mp.step_round([None, None])
    for st0, st1 in zip(before, mp.states):
        for name, a, b in zip(st1._fields, st0, st1):
            if name == "total_steps":
                assert int(b) == int(a) + 1
            else:
                assert torch.equal(a, b), name


def test_idle_sequence_that_never_scanned():
    """A feed that ends before calibration gets the inert default state and
    idles through ``_pack_idle`` inputs (both wire formats): its state
    stays the init state apart from ``total_steps``."""
    sim = synthetic.make_sim(duration=0.6, n_points=1024, calib_time=3.1,
                             seed=5)
    scans = [sim.scan(i) for i in range(len(sim.scan_stamps))]
    for quantized in (True, False):
        cfg = _cfg()
        cfg = cfg.replace(preproc=dataclasses.replace(
            cfg.preproc, quantized_wire=quantized))
        mp = MultiSequencePipeline(cfg, n_seq=2, devices=TWO)
        dead = ArrayFeed(sim.imu_stamps[:10], sim.imu_ang[:10],
                         sim.imu_acc[:10], sim.scan_stamps, lambda i: scans[i])
        out = run_lockstep(mp, [_feed((sim, scans)), dead])
        assert len(out[0]) > 2 and len(out[1]) == 0
        init = pbatch.init_batched_state(cfg, 1, "cpu")
        st = mp.states[1]
        for name, a, b in zip(st._fields, pbatch.unstack_state(init, 0), st):
            if name == "total_steps":
                assert int(b) == mp.rounds
            else:
                assert torch.equal(a, b), name


def test_need_more_imu_before_any_state_change(sims):
    """A round whose scan the IMU does not cover raises NeedMoreImu before
    any sequence's state or bookkeeping changes."""
    mp = MultiSequencePipeline(_cfg(), n_seq=2, devices=TWO)
    pull = _puller(mp, [_feed(s) for s in sims])
    for _ in range(2):
        mp.step_round([pull(0), pull(1)])
    before = [[x.clone() for x in st] for st in mp.states]
    heads = [list(f.headers) for f in mp.frontends]
    sim, scans = sims[1]
    late = scans[-1]                      # its sweep is past the IMU fed
    with pytest.raises(NeedMoreImu):
        mp.step_rounds([[pull(0), None], [None, late]])
    assert mp.rounds == 2 and [f.headers for f in mp.frontends] == heads
    for st0, st1 in zip(before, mp.states):
        assert all(torch.equal(a, b) for a, b in zip(st0, st1))


def test_midstream_stall_matches_solo(sims, solo):
    """Idle rounds injected mid-sequence (an IMU-stalled sequence rides
    along) do not perturb that sequence's trajectory."""
    mp = MultiSequencePipeline(_cfg(), n_seq=2, devices=TWO)
    pull = _puller(mp, [_feed(s) for s in sims])
    pending = [pull(0), pull(1)]
    rounds = 0
    while any(p is not None for p in pending):
        scans = list(pending)
        if 3 <= rounds < 6 and scans[1] is not None:
            scans[1] = None                # stall sequence 1 for 3 rounds
            mp.step_round(scans)
            pending[0] = pull(0) if pending[0] is not None else None
            rounds += 1
            continue
        mp.step_round(scans)
        pending = [pull(i) if pending[i] is not None else None
                   for i in range(2)]
        rounds += 1
    for r, o in zip(solo, [mp.flush(0), mp.flush(1)]):
        _same(o, r)


def test_checkpoint_resume_matches_uninterrupted(sims, full, tmp_path):
    """Save a 2-sequence run mid-stream and resume it in a new pipeline:
    the combined trajectories equal the uninterrupted run exactly."""
    mp1 = MultiSequencePipeline(_cfg(), n_seq=2, devices=["cpu"])
    feeds = [_feed(s) for s in sims]
    pull = _puller(mp1, feeds)
    for _ in range(4):
        mp1.step_round([pull(0), pull(1)])
    part1 = [mp1.flush(0).copy(), mp1.flush(1).copy()]
    path = str(tmp_path / "batch.nst.npz")
    mp1.save(path, feeds)
    del mp1

    mp2 = MultiSequencePipeline(_cfg(), n_seq=2, devices=["cpu"])
    feeds2 = [_feed(s) for s in sims]
    mp2.load(path, feeds2)
    assert mp2.rounds == 4
    part2 = run_lockstep(mp2, feeds2)
    for i in range(2):
        _same(np.vstack([part1[i], part2[i]]), full[i])
    with pytest.raises(ValueError, match="2 sequences, pipeline 4"):
        MultiSequencePipeline(_cfg(), n_seq=4, devices=["cpu"]).load(path)


def test_multi_round_dispatch_parity(sims):
    """K rounds per upload == one round per upload, including ragged
    tails (idle padding inside a K-batch), exactly."""
    mp1 = MultiSequencePipeline(_cfg(), n_seq=2, devices=TWO)
    one = run_lockstep(mp1, [_feed(sims[0]), _feed(sims[1], max_scans=7)])
    mp3 = MultiSequencePipeline(_cfg(), n_seq=2, devices=TWO)
    k3 = run_lockstep(mp3, [_feed(sims[0]), _feed(sims[1], max_scans=7)],
                      rounds_per_dispatch=3)
    assert mp3.rounds == mp1.rounds
    for a, b in zip(one, k3):
        _same(b, a)


def test_checkpoint_roundtrip_two_devices(sims, full, tmp_path):
    """save/load with the sequences on two devices: stacking the states
    into the file and back keeps the trajectories exact."""
    mp1 = MultiSequencePipeline(_cfg(), n_seq=2, devices=TWO)
    feeds = [_feed(s) for s in sims]
    pull = _puller(mp1, feeds)
    for _ in range(3):
        mp1.step_round([pull(0), pull(1)])
    part1 = [mp1.flush(0).copy(), mp1.flush(1).copy()]
    path = str(tmp_path / "batch_two.nst.npz")
    mp1.save(path, feeds)
    stacked = pbatch.stack_states(mp1.states)
    mp2 = MultiSequencePipeline(_cfg(), n_seq=2, devices=TWO)
    feeds2 = [_feed(s) for s in sims]
    mp2.load(path, feeds2)
    for i, f in enumerate(mp2.frontends):
        for name, a, b in zip(f.state._fields,
                              pbatch.unstack_state(stacked, i), f.state):
            assert torch.equal(a, b), name
    part2 = run_lockstep(mp2, feeds2)
    for i in range(2):
        _same(np.vstack([part1[i], part2[i]]), full[i])


# ---------------------------------------------------------------------------
# Against the JAX MultiSequencePipeline (unsharded), on the same feeds
# ---------------------------------------------------------------------------

def _close_to(got, ref):
    assert got.shape == ref.shape and len(ref) > 4
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=0, atol=1e-6)
    err = np.linalg.norm(got[:, 1:4] - ref[:, 1:4], axis=1)
    assert err.max() < POSE_TOL, err.max()


@pytest.fixture(scope="module")
def jax_full(sims):
    mp = jmulti.MultiSequencePipeline(jax_cfg(_cfg()), n_seq=2)
    return run_lockstep_jax(mp, sims)


def run_lockstep_jax(mp, sims, feeds=None):
    feeds = feeds or [_feed(s, cls=jmulti.ArrayFeed) for s in sims]
    return jmulti.run_lockstep(mp, feeds)


def test_matches_jax_multi_sequence(sims, full, jax_full):
    for got, ref in zip(full, jax_full):
        _close_to(got, ref)
    for (sim, _), o in zip(sims, jax_full):
        assert jsyn.ate_rmse(o[:, 0], o[:, 1:4], sim.gt_stamps,
                             sim.gt_pos) < 0.08


def test_jax_checkpoint_resumes_in_port(sims, jax_full, tmp_path):
    """JAX ``save`` after 4 rounds -> port ``load`` -> continue: the loaded
    states are the saved arrays bitwise, and the combined trajectories stay
    within the replay tolerance of JAX's uninterrupted run."""
    jmp = jmulti.MultiSequencePipeline(jax_cfg(_cfg()), n_seq=2)
    jfeeds = [_feed(s, cls=jmulti.ArrayFeed) for s in sims]
    jpull = _puller(jmp, jfeeds)
    for _ in range(4):
        jmp.step_round([jpull(0), jpull(1)])
    part1 = [jmp.flush(0).copy(), jmp.flush(1).copy()]
    path = str(tmp_path / "jax_batch.nst.npz")
    jmp.save(path, jfeeds)

    mp = MultiSequencePipeline(_cfg(), n_seq=2, devices=TWO)
    feeds = [_feed(s) for s in sims]
    mp.load(path, feeds)
    assert mp.rounds == 4
    assert [fd.cursor() for fd in feeds] == [fd.cursor() for fd in jfeeds]
    with np.load(path) as data:
        for i, f in enumerate(mp.frontends):
            for name, t in zip(f.state._fields, f.state):
                np.testing.assert_array_equal(
                    t.numpy(), data[f"odom{i}/{name}"], err_msg=name)
    part2 = run_lockstep(mp, feeds)
    for i in range(2):
        _close_to(np.vstack([part1[i], part2[i]]), jax_full[i])


def test_port_checkpoint_resumes_in_jax(sims, full, tmp_path):
    """The reverse: port ``save`` (with JAX's grid fields written
    init-shaped) -> JAX ``load`` -> continue, within the replay tolerance
    of the port's uninterrupted run."""
    mp = MultiSequencePipeline(_cfg(), n_seq=2, devices=TWO)
    feeds = [_feed(s) for s in sims]
    pull = _puller(mp, feeds)
    for _ in range(4):
        mp.step_round([pull(0), pull(1)])
    part1 = [mp.flush(0).copy(), mp.flush(1).copy()]
    path = str(tmp_path / "port_batch.nst.npz")
    mp.save(path, feeds)

    jmp = jmulti.MultiSequencePipeline(jax_cfg(_cfg()), n_seq=2)
    jfeeds = [_feed(s, cls=jmulti.ArrayFeed) for s in sims]
    jmp.load(path, jfeeds)
    assert jmp.rounds == 4
    for i, f in enumerate(jmp.frontends):
        np.testing.assert_array_equal(np.asarray(f.state.kf_xyz),
                                      mp.states[i].kf_xyz.numpy())
    part2 = run_lockstep_jax(jmp, sims, jfeeds)
    for i in range(2):
        _close_to(np.vstack([part1[i], part2[i]]), full[i])


# ---------------------------------------------------------------------------
# cli batch
# ---------------------------------------------------------------------------

def _main(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


@pytest.mark.skipif(not os.path.isdir(FIXTURE),
                    reason="mulran_mini fixture not present")
def test_cli_batch_matches_jax(tmp_path):
    """``cli batch`` on the MulRan fixture plus one synthetic sequence (as
    tests/test_multi_pipeline.py:170 runs it, ``--devices 2``): the port
    (``--device cpu``, so one device) and JAX write the same files and
    stdout fields, with trajectories within the replay tolerance; then
    both resume from the port's checkpoint."""
    from noetic_slam_tpu import cli as jcli
    from noetic_slam_tpu_torch import cli as tcli

    cfg_yaml = tmp_path / "small.yaml"
    cfg_yaml.write_text(
        "capacity:\n"
        "  max_points: 2048\n  max_ds_points: 1024\n"
        "  max_deskew_frames: 128\n  max_imu_window: 64\n"
        "  max_keyframes: 64\n  max_submap_kf: 32\n"
        "  max_trajectory: 512\n")
    argv = ["batch", "--mulran", FIXTURE, "--synthetic", "1",
            "--duration", "1.5", "--config", str(cfg_yaml),
            "--max-scans", "24", "--devices", "2", "--checkpoint"]
    outs = {}
    for cli, tag, extra in ((tcli, "port", ["--device", "cpu"]),
                            (jcli, "jax", [])):
        out = tmp_path / tag
        rc, stdout = _main(cli, argv + ["--out", str(out)] + extra)
        assert rc == 0
        outs[tag] = (out, stdout)
    (pout, pstd), (jout, jstd) = outs["port"], outs["jax"]
    assert pstd.splitlines()[0] == "batch: 2 sequences over 1 device(s)"
    assert jstd.splitlines()[0] == "batch: 2 sequences over 2 device(s)"
    pj, jj = (json.loads(s.splitlines()[-1]) for s in (pstd, jstd))
    assert sorted(pj) == sorted(jj)
    assert [sorted(e) for e in pj["sequences"]] == [
        sorted(e) for e in jj["sequences"]]
    assert pj["rounds"] == jj["rounds"] and pj["total_poses"] == jj[
        "total_poses"]
    names = sorted(p.name for p in jout.iterdir())
    assert sorted(p.name for p in pout.iterdir()) == names
    assert len([n for n in names if n.endswith(".tum")]) == 2
    for name in names:
        if name.endswith(".tum"):
            _close_to(np.loadtxt(pout / name), np.loadtxt(jout / name))
    for e in pj["sequences"]:
        assert e["ate_rmse_m"] < 0.5
    # resume from the port's checkpoint, in both packages: the feeds are
    # exhausted, so both finish at once with the same round count
    ck = str(pout / "batch_state.nst.npz")
    for cli, tag, extra in ((tcli, "port_r", ["--device", "cpu"]),
                            (jcli, "jax_r", [])):
        rc, stdout = _main(cli, argv[:-1] + [
            "--resume", ck, "--out", str(tmp_path / tag)] + extra)
        assert rc == 0
        assert f"at round {pj['rounds']}" in stdout
        assert json.loads(stdout.splitlines()[-1])["rounds"] == pj["rounds"]


def test_cli_batch_without_device_raises_where_there_is_no_card(
        tmp_path, monkeypatch):
    from noetic_slam_tpu_torch import cli as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["batch", "--synthetic", "1", "--duration", "0.5",
                   "--out", str(tmp_path)])
