"""One run of one benchmark cell of the PyTorch + CUDA port
(``ros_stereo_slam_tpu_torch``) on the card it starts on.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run makes the cell's frames on the card
from `--seed` (the mix's world: its scene, plan and sensor noise) and, for
full SLAM, loads the vocabulary (trained and kept under
``build/slambench/`` by a checkout's first run), warms the program up on
the cell's own frames, measures whole sessions for `--seconds`, then
holds what the timed path produced against the plain reference and the
ground truth (poses, closures, loop edges, the pose graph, and a sample
of the calls of each site the cell names, drawn from `--seed`) and
prints one JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, from a ``torch.profiler``
capture of the window's first session and the program's spans in it),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``:
each number compared with its limit (also the last lines of standard
error).  Progress goes to standard error.

The readers of the per-layer metrics take one record: ``trace`` (the
capture, :mod:`slambench.trace`), ``spans`` (the program's spans in the
traced session), ``frames`` (the frames of the traced session, every
lane's) and ``<site>_work`` (the operations and bytes of each call a
site kept, where the site counts them).

It exits non-zero without a result when no card is present, when the
card count is below the cell's, or when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ros_stereo_slam_tpu")


def log(msg: str) -> None:
    print(f"[slambench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m slambench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def smi_line() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    proc = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30)
    return proc.stdout.strip() or proc.stderr.strip()


def _e2e(name: str, window, setup_s: float, attempted: int):
    if name == "setup_s":
        return setup_s
    if name == "fps":
        return attempted / window.seconds
    raise KeyError(f"no end-to-end metric {name!r}")


class Setup:
    """What a run makes before its window: the cell's data and files, the
    seeds drawn from `--seed`, the frames, the vocabulary and the warmed
    program entry."""

    def __init__(self, args, device, root: Path):
        import torch

        from slambench import drivers, manifest, vocabulary, world

        self.man = manifest.Manifest(root)
        self.cell = self.man.cell(args.workload)
        self.conf = self.man.config(self.cell["config"])
        self.mix = self.man.traffic(self.cell["traffic"])
        self.cell_file = self.man.cell_file(self.cell["name"])
        self.device = device
        self.cuda = torch.device(device).type == "cuda"
        cam = self.conf["camera"]
        self.seeds = world.draw(args.seed)
        torch.set_num_threads(1)  # one process, one host thread: the host path is serial
        import ros_stereo_slam_tpu_torch  # noqa: F401  (the program sets its float policy)

        t = time.perf_counter()
        self.frames = world.make_frames(self.mix["world"], cam, device, self.seeds)
        drivers.synchronize(device)
        log(f"frames: {len(self.frames)} at {cam['width']}x{cam['height']} in "
            f"{time.perf_counter() - t:.2f} s; seeds {self.seeds}")
        # a recorded drive: 8-bit frames in host memory
        self.left, self.right = self.frames.left.cpu().numpy(), self.frames.right.cpu().numpy()
        self.centers, voc = None, None
        if self.conf.get("vocabulary"):
            t = time.perf_counter()
            spec = self.conf["vocabulary"]
            self.centers, idf, info = vocabulary.make(spec, cam, device,
                                                      Path(root) / "build" / "slambench")
            voc = drivers.program_vocabulary(self.centers, idf, spec["k"])
            drivers.synchronize(device)
            log(f"vocabulary: k={spec['k']} L={spec['levels']} {info} in "
                f"{time.perf_counter() - t:.2f} s")
        cfg = drivers.pipeline_config(self.conf, self.mix.get("overrides", {}),
                                      self.seeds["program"])
        self.driver = drivers.make(self.mix["driver"], cfg, voc, device, self.man.dir)
        t = time.perf_counter()
        n_warm = int(self.mix["warm_frames"])
        self.driver.session(self.left[:n_warm], self.right[:n_warm])
        drivers.synchronize(device)
        log(f"warm-up: {n_warm} frames in {time.perf_counter() - t:.2f} s")

    def measure(self, seconds: float, traced: bool = False):
        """Sessions for `seconds` with the sites' calls sampled (and, if
        `traced`, the first session captured): (window, recorder, trace
        record, {site: its kept calls' work}, peak device bytes)."""
        import torch

        from slambench import drivers, loops, record, trace

        device = self.device
        quota = self.cell_file["samples"]
        rec = record.Recorder(self.left.shape[1:], self.seeds["sample"],
                              {k: self.man.site(k) for k in quota}, quota)
        rec.install()
        capture = trace.Capture() if traced else None
        got: dict = {}

        @contextlib.contextmanager
        def hooks(i: int):
            if capture is None or i > 0:
                yield
                return
            drivers.synchronize(device)
            rec.tracing = True
            capture.start()
            with capture.span(trace.SESSION_SPAN):
                yield
                drivers.synchronize(device)
            got.update(capture.stop())
            rec.tracing = False

        if self.cuda:
            torch.cuda.reset_peak_memory_stats(device)
        drivers.synchronize(device)
        gc.collect()
        gc.freeze()  # set-up's objects stay out of the window's collections
        rec.active = True
        try:
            window = loops.closed_loop(self.driver, self.left, self.right, seconds, hooks)
            drivers.synchronize(device)
        finally:
            rec.active = False
            gc.unfreeze()
        peak = torch.cuda.max_memory_allocated(device) if self.cuda else 0
        work = {}
        for name, tap in rec.taps.items():
            if traced and hasattr(tap.site, "work"):
                work[name] = [w for w in (tap.site.work(tap.orig, c) for c in tap.kept)
                              if w is not None]
                log(f"{name} work: {len(work[name])} launches recorded, bound by "
                    f"{sorted({w['bound_by'] for w in work[name]})}")
        rec.uninstall()
        return window, rec, got, work, peak

    def counts(self, window) -> tuple[int, int]:
        """(frames offered, frames failed) of the window's sessions, every
        lane's."""
        from slambench import drivers

        n = len(self.frames)
        sessions = drivers.flatten(window.sessions)
        failed = sum(n - int(s.tracking_ok.sum()) if s.error is None else n for s in sessions)
        return len(sessions) * n, failed

    def judge(self, window, rec):
        """(correct, checks, what the log shows beside them): the window's
        outputs against the reference, each number against the cell's
        limit."""
        from slambench import check

        nums, info = check.compare(window.sessions, self.frames, rec, self.centers, self.conf,
                                   self.device)
        limits = self.cell_file["limits"]
        ok, checks = check.judge(nums, limits)
        info.update({k: v for k, v in nums.items() if k not in limits})
        return ok, checks, info


def run(args, device, root: Path = ROOT, faults=None) -> int:
    """The run on `device`; returns the exit code.  `faults()`, if given,
    plants a fault under the timed path before the window (the tests'
    controls, :mod:`slambench.faults`)."""
    import torch

    from slambench import drivers, trace

    st = Setup(args, device, root)
    if faults is not None:
        faults()
    setup_s = time.perf_counter() - _T0
    log(f"set-up {setup_s:.3f} s; window of {args.seconds} s starts")
    cpu = time.process_time()
    window, rec, traced, work, peak = st.measure(args.seconds, bool(args.trace))
    log(f"sessions ended at {[round(t, 3) for t in window.session_ends]} s; process CPU "
        f"{time.process_time() - cpu:.3f} s")
    attempted, failed = st.counts(window)
    for s in drivers.flatten(window.sessions):
        if s.error:
            log(f"a session raised:\n{s.error}")
    log(f"window: {len(window.sessions)} sessions, {attempted} frames, {failed} failed, "
        f"{window.seconds:.3f} s; site calls {rec.calls}")
    st.driver = None
    if st.cuda:
        torch.cuda.empty_cache()
    ok, checks, info = st.judge(window, rec)
    log(f"beside the checks: {json.dumps(info)}")

    out = {"correct": ok, "attempted": attempted, "failed": failed}
    cell, man = st.cell, st.man
    if args.trace:
        record_in = {"trace": traced, "spans": traced["spans"],
                     "frames": len(drivers.flatten(window.sessions[:1])) * len(st.frames),
                     **{f"{k}_work": w for k, w in work.items()}}
        values = {m["name"]: (m, man.reader(m["name"])(record_in))
                  for m in man.metrics(cell["name"], "per_layer")}
    else:
        values = {m["name"]: (m, _e2e(m["name"], window, setup_s, attempted))
                  for m in man.metrics(cell["name"], "end_to_end")}
    out["metrics"] = {n: {"value": v, "unit": m["unit"]} for n, (m, v) in values.items()
                      if v is not None}
    dev = {"platform": "gpu" if st.cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if st.cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if args.trace:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        out["breakdown"] = {"device_ops": trace.device_ops(traced),
                            "idle_gaps": trace.idle_gaps(traced)}
    out["device"] = dev
    out["checks"] = checks

    bad = forbidden_modules()
    if bad:
        log(f"refusing to report: modules of JAX or the JAX package are loaded: {bad}")
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from slambench import manifest

    chips = int(manifest.Manifest(ROOT).cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"needs {chips} CUDA card(s), found {n}: no result")
        return 2
    log(f"card: {smi_line()}")
    return run(args, "cuda:0")


if __name__ == "__main__":
    sys.exit(main())
