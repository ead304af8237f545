"""One run of a cell: set-up, the measured window, the traced span and the
check against the plain reference.

The loop is closed: the next frame is fed when the call returns, as a
dataset replay or a robot's tracking thread feeds a SLAM system. A session
is the mix's fixed sequence of frames; its last frame is followed by
``System.reset()`` and the same frames again, inside the window, so the
work of a frame does not depend on how fast the program is. At the deadline
the feed stops and ``System.flush()`` ends the window.

Every number is taken from the program's public surface: the frames it is
fed, its trajectory export, its map store and dense mesh after the window,
its Stopwatch spans, its kernel launch counters, and (for the check) the
inputs and outputs of a seeded sample of its kernel launches.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from . import registry, roofline, trace, traffic
from .reference import check as ref_check

OK = 2  # the tracker's OK state (plvs_tpu_torch/slam/tracking.py)


def _rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)), tag])


def make_stopwatch(base):
    """A subclass of the program's Stopwatch that also logs each scope's
    (name, start_ns, end_ns) on ``time.time_ns`` while ``log`` is a list
    (the profiler's clock), to name the device's idle gaps."""

    class Watch(base):
        def __init__(self):
            super().__init__()
            self.log = None
            self._open_ns = {}

        def tick(self, name):
            super().tick(name)
            if self.log is not None:
                self._open_ns[name] = time.time_ns()

        def tock(self, name, block_on=None):
            super().tock(name, block_on)
            if self.log is not None:
                s = self._open_ns.pop(name, None)
                if s is not None:
                    self.log.append((name, s, time.time_ns()))

    return Watch()


class KernelTap:
    """Keeps a seeded uniform sample (reservoir) of the window's K1 and K2
    launches and line extractions: clones of each sampled call's inputs and
    outputs, queued on the device right after the call."""

    def __init__(self, seed: int, keep: dict | None = None):
        self.rng = _rng(seed, 2)
        self.keep = keep or {"k1": 8, "k2": 4, "lines": 4}
        self.samples = {k: [] for k in self.keep}
        self.offered = {k: 0 for k in self.keep}
        self.active = False

    def _offer(self, kind: str, tensors, extra=None):
        self.offered[kind] += 1
        n, keep, kept = self.offered[kind], self.keep[kind], self.samples[kind]
        if len(kept) < keep:
            kept.append((tuple(t.clone() for t in tensors), extra))
            return
        j = int(self.rng.integers(n))
        if j < keep:
            kept[j] = (tuple(t.clone() for t in tensors), extra)

    def install(self):
        from plvs_tpu_torch.features import lines
        from plvs_tpu_torch.ops import cc_labels, hamming

        # the program's own functions, also where a tap is installed again
        k1 = getattr(hamming.hamming_matrix, "__wrapped__",
                     hamming.hamming_matrix)
        k2 = getattr(cc_labels.cc_min_labels, "__wrapped__",
                     cc_labels.cc_min_labels)
        ex = getattr(lines.extract_lines, "__wrapped__", lines.extract_lines)

        def hamming_matrix(d1, d2):
            out = k1(d1, d2)
            if self.active:
                self._offer("k1", (d1, d2, out))
            return out

        def cc_min_labels(init, conn_bits, *a, **kw):
            out = k2(init, conn_bits, *a, **kw)
            if self.active:
                self._offer("k2", (init, conn_bits, out))
            return out

        def extract_lines(img, max_lines=128, **kw):
            out = ex(img, max_lines=max_lines, **kw)
            if self.active and not kw:
                self._offer("lines", (img, out.sp, out.ep, out.mask),
                            max_lines)
            return out

        for fn, orig in ((hamming_matrix, k1), (cc_min_labels, k2),
                         (extract_lines, ex)):
            fn.__wrapped__ = orig
        hamming.hamming_matrix = hamming_matrix
        cc_labels.cc_min_labels = cc_min_labels
        lines.extract_lines = extract_lines


class Probe:
    """Records, for each frame the System resolves, its timestamp and final
    state (a wrapper around ``System._post_track``, the common tail of every
    resolved frame; it survives ``reset()``)."""

    def __init__(self, system):
        self.resolved = []
        post = system._post_track

        def post_track(res, timestamp, dense_payload=None):
            out = post(res, timestamp, dense_payload)
            self.resolved.append((float(timestamp), int(res.state)))
            return out

        system._post_track = post_track

    def take(self):
        got, self.resolved = self.resolved, []
        return got


@dataclasses.dataclass
class SessionLog:
    """Frames fed in one session of the window."""

    traj_start: int               # its first row in System.trajectory
    t0: dict = dataclasses.field(default_factory=dict)    # ts -> call start
    t_call_end: dict = dataclasses.field(default_factory=dict)
    t_done: dict = dataclasses.field(default_factory=dict)  # ts -> resolved
    state: dict = dataclasses.field(default_factory=dict)
    fed: list = dataclasses.field(default_factory=list)    # ts in order
    complete: bool = False
    store: object = None
    dense: object = None
    keyframes: int = 0


def build_system(cell: registry.Cell, device: str):
    """The System as ``run_slam --settings`` builds it from the cell's
    configuration file, then the file's ``SystemConfig.*`` runtime keys and
    its sensor."""
    from plvs_tpu_torch.slam import System
    from plvs_tpu_torch.slam.settings import Settings

    st = Settings.from_yaml(cell.config_path)
    cfg = st.config
    for key, val in cell.config.items():
        if key.startswith("SystemConfig."):
            field = key.split(".", 1)[1]
            if not hasattr(cfg, field):
                raise ValueError(f"{cell.config_name}: SystemConfig has no "
                                 f"field {field!r}")
            setattr(cfg, field, val)
    cfg.sensor = cell.config["Bench.sensor"]
    return System(st.camera, cfg, device=device, cam2=st.camera2,
                  T_c1_c2=st.T_c1_c2, imu_calib=st.imu,
                  imu_T_b_c=st.imu_T_b_c)


def set_precision(config: dict, tf32: bool = False):
    """Run the program in the precision its configuration states. float32
    is the only one: TF32 stays off (``tf32`` turns it on, for the
    lower-precision control only)."""
    import torch

    if config.get("Bench.precision") != "float32":
        raise ValueError(f"unsupported precision {config.get('Bench.precision')!r}")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _feed(system, sensor: str, frame):
    ts, a, b = frame
    if sensor == "rgbd":
        return system.track_rgbd(a, b, ts)
    return system.track_stereo(a, b, ts)


def run_window(system, session, seconds: float, probe: Probe, watch,
               clock=time.perf_counter, max_sessions: int | None = None):
    """Feed sessions until ``seconds`` have passed (or ``max_sessions`` are
    complete), then flush. Returns (session logs, window start, window
    end)."""
    frames = session.frames
    logs = []
    t_start = clock()
    deadline = t_start + seconds
    stopped = False
    probe.take()
    while not stopped:
        log = SessionLog(len(system.trajectory))
        logs.append(log)

        def stamp(t, log=log):
            for ts, state in probe.take():
                log.t_done[ts] = t
                log.state[ts] = state

        for frame in frames:
            if clock() >= deadline:
                stopped = True
                break
            ts = frame[0]
            log.t0[ts] = clock()
            log.fed.append(ts)
            _feed(system, session.sensor, frame)
            t = clock()
            log.t_call_end[ts] = t
            stamp(t)
        if stopped:
            break
        log.complete = True
        log.store = system.store
        if clock() >= deadline or (max_sessions is not None
                                   and len(logs) >= max_sessions):
            break
        # the last complete session's dense map is kept for the check
        for old in logs[:-1]:
            old.dense = None
        log.dense = system.dense_mapper
        system.reset()
        system.set_stopwatch(watch)
        stamp(clock())
    system.flush()
    t_end = clock()
    last = logs[-1]
    for ts, state in probe.take():
        last.t_done[ts] = t_end
        last.state[ts] = state
    if not last.complete:
        last.store = system.store
    else:
        for old in logs[:-1]:
            old.dense = None
        last.dense = system.dense_mapper
    for log in logs:
        log.keyframes = int(log.store._next_kf_uid)
    return logs, t_start, t_end


def frame_latencies_ms(logs) -> list:
    """Per frame of the window: its call's start to the return of the call
    (or the flush or reset) after which its pose was in the trajectory."""
    out = []
    for log in logs:
        for ts in log.fed:
            if ts in log.t_done:
                out.append((log.t_done[ts] - log.t0[ts]) * 1e3)
    return out


def span_wall_s(logs, a: int, b: int, fps: float):
    """Median over the window's sessions of the host time from the start of
    frame a's call to the return of frame b-1's (no synchronisation)."""
    walls = []
    ta, tb = a / fps, (b - 1) / fps
    for log in logs:
        if ta in log.t0 and tb in log.t_call_end:
            walls.append(log.t_call_end[tb] - log.t0[ta])
    return float(np.median(walls)) if walls else None


def count_failed(logs, first_ts: float) -> int:
    """Frames fed that never resolved, or resolved in a state other than
    OK, except each session's first frame (the map's initialisation)."""
    n = 0
    for log in logs:
        for ts in log.fed:
            if ts == first_ts:
                continue
            if log.state.get(ts) != OK:
                n += 1
    return n


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda", t_process: float | None = None,
             bench_dir: str = registry.HERE, tf32: bool = False,
             max_sessions: int | None = None, faults=()):
    """One run: the result object run.py prints (``checks`` its last key),
    plus ``readings``, every number the check can compare (run.py drops
    it). ``faults`` (``faults.py``) plants breaks in the timed path, to show
    that a broken program fails the check."""
    clock = time.perf_counter
    t_process = clock() if t_process is None else t_process
    cell = registry.load_cell(root, workload, bench_dir)
    session = traffic.build_session(cell.traffic, cell.config, seed)

    for fault in faults:
        fault.install()
    try:
        return _run(cell, session, seed, seconds, traced, device, t_process,
                    clock, tf32, max_sessions)
    finally:
        for fault in reversed(faults):
            fault.remove()


def _run(cell, session, seed, seconds, traced, device, t_process, clock,
         tf32, max_sessions):
    import torch
    from plvs_tpu_torch.utils.profiling import Stopwatch

    set_precision(cell.config, tf32)
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        from plvs_tpu_torch.ops import _build

        _build.build_all()
    tap = KernelTap(seed)
    tap.install()
    system = build_system(cell, device)
    probe = Probe(system)
    # warm-up: enough frames that a keyframe has run its backend (and the
    # dense insert where the configuration maps densely), then a reset
    n_warm = int(cell.traffic["warmup_frames"])
    for frame in session.frames[:n_warm]:
        _feed(system, session.sensor, frame)
    system.reset()
    watch = make_stopwatch(Stopwatch)
    system.set_stopwatch(watch)
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tap.active = True
    setup_s = clock() - t_process
    logs, t0, t1 = run_window(system, session, seconds, probe, watch,
                              clock=clock, max_sessions=max_sessions)
    tap.active = False
    window_s = t1 - t0
    memory_peak = int(torch.cuda.max_memory_allocated()) if is_cuda else 0
    n_resolved = sum(len(log.t_done) for log in logs)
    attempted = sum(len(log.fed) for log in logs)
    first_ts = session.frames[0][0]
    failed = count_failed(logs, first_ts)
    rows = system.trajectory_tum()
    window_stats = {k: list(v) for k, v in watch.samples.items()}
    keyframes = sum(log.keyframes for log in logs)

    span = None
    if traced:
        span = _profiled_span(system, session, cell, watch, probe, is_cuda)
    readings_in = _session_outputs(logs, rows, session)
    system.shutdown()
    del system
    for log in logs:
        log.store = log.dense = None
    if is_cuda:
        torch.cuda.empty_cache()
    readings = ref_check.readings(readings_in, session, tap.samples)
    correct, checks = ref_check.judge(readings, cell.limits)

    metrics = {}
    if not traced:
        # every end-to-end value the harness can give; BENCHMARK.json
        # chooses which a cell reports
        values = {"frames_per_s": n_resolved / window_s, "setup_s": setup_s}
        for m in cell.end_to_end:
            v = values.get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = {
            "latencies_ms": frame_latencies_ms(logs),
            "stopwatch": window_stats,
            "frames": n_resolved,
            "keyframes": keyframes,
            "span": span,
            "k2_shape": (session.frames[0][1].shape[0] // 2,
                         session.frames[0][1].shape[1] // 2),
            "span_wall_unprofiled_s": span_wall_s(
                logs, *cell.traffic["profile_frames"], session.fps),
            "roofline": roofline,
            "trace": trace,
        }
        for m in cell.metrics:
            v = m.read(ctx)
            if v is not None and math.isfinite(v):
                metrics[m.name] = {"value": float(v), "unit": m.unit}
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": memory_peak}
    if traced:
        dev["busy_s"] = span["busy_s"]
        dev["window_s"] = span["window_s"]
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = span["breakdown"]
    result["readings"] = dict(readings, window_s=window_s, setup_s=setup_s,
                              frames=n_resolved, keyframes=keyframes,
                              sessions_fed=len(logs))
    result["checks"] = checks
    return result


def _profiled_span(system, session, cell, watch, probe, cuda) -> dict:
    """After the window: a fresh session fed unprofiled up to the mix's
    ``profile_frames`` [a, b), those frames under the profiler, then a
    flush. Also diffs the kernels' launch counters over the span."""
    from plvs_tpu_torch.ops import cc_labels, hamming

    a, b = cell.traffic["profile_frames"]
    system.reset()
    system.set_stopwatch(watch)
    for frame in session.frames[:a]:
        _feed(system, session.sensor, frame)
    shapes0 = dict(hamming.shapes)
    k2_0 = cc_labels.launches
    watch.log = []

    def run():
        for frame in session.frames[a:b]:
            _feed(system, session.sensor, frame)

    span = trace.profile_span(run, watch.log, cuda)
    watch.log = None
    span["k1_shapes"] = {s: n - shapes0.get(s, 0)
                         for s, n in hamming.shapes.items()
                         if n - shapes0.get(s, 0) > 0}
    span["k2_launches"] = cc_labels.launches - k2_0
    system.flush()
    probe.take()
    return span


def _session_outputs(logs, rows, session) -> list:
    """What each complete session of the window produced, read after the
    window: its trajectory rows as the port exports them, its map's live
    points and line endpoints, and, for the last complete session of a
    dense configuration, the vertices of its mesh."""
    n = len(session.frames)
    out = []
    complete = [log for log in logs if log.complete]
    for i, log in enumerate(complete):
        st = log.store
        traj = rows[log.traj_start:log.traj_start + n]
        item = {
            "traj": np.asarray(traj, np.float64),
            "not_ok": sum(1 for ts in log.fed[1:]
                          if log.state.get(ts) != OK),
            "points": st.pt_xyz[st.pt_mask].astype(np.float64),
            "lines": np.concatenate([st.ln_Xs[st.ln_mask],
                                     st.ln_Xe[st.ln_mask]]).astype(np.float64),
            "mesh": None,
        }
        if log.dense is not None and i == len(complete) - 1:
            V, _ = log.dense.mesher.update(assemble=True)
            item["mesh"] = np.asarray(V, np.float64)
        out.append(item)
    return out
