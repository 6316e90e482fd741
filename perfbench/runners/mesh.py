"""One NCCL rank a card on a (ranks, 1) mesh, the global batch split in
rows over the ranks.

Each rank stages its own pinned rows of the step on a side stream, makes
them the step's sharded batch (`parallel.host_local_batch`) and calls the
mesh detector's `detect`, which runs the rank's rows and all-gathers the
slab; rank 0 trims all rows of the step.  Two steps are kept in flight, as
`runtime.streaming.detect_stream` does (which takes no sharded batch).
Every `sync_every` steps the ranks agree over a gloo group whether rank
0's clock has passed the window's end.  A step's latency runs on rank 0
from the staging of its rows to its `trim()`.  The answers rank 0 trimmed
for a seed-drawn sample of steps are compared with the plain reference on
rank 0's card once every rank has freed its detector."""
from __future__ import annotations

import importlib
import queue
import socket
import time
import traceback
from collections import deque

import numpy as np
import torch

from ..harness import frames as framegen
from ..harness import metrics, trace
from . import common


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cell, seed: int, seconds: float, traced: bool, t0: float,
        device="cuda", ranks: int | None = None, hook: str | None = None,
        jobs: list | None = None, timeout: float = 300.0):
    """Spawn the ranks, wait for them, return rank 0's result.  `ranks`
    overrides the traffic's; `hook` ("module:function") is called in every
    rank before its detector is built; `jobs`, a list of (seed, control),
    runs a window a job in the same ranks (control: the program with TF32
    switched on) and returns rank 0's results as a list."""
    import multiprocessing as mp

    world = int(ranks or cell.traffic["ranks"])
    t0_wall = time.time() - (time.perf_counter() - t0)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    todo = jobs if jobs is not None else [(seed, False)]
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, port, cell, todo, seconds, traced, t0_wall, device, hook,
        results), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                r, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"mesh ranks {dead} ended without a result"
                        if dead else f"mesh ranks timed out after {timeout} s")
                continue
            if isinstance(out, dict) and "error" in out:
                raise RuntimeError(f"mesh rank {r} failed:\n{out['error']}")
            got[r] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return got[0] if jobs is not None else got[0][0]


def _rank_main(rank, world, port, cell, jobs, seconds, traced, t0_wall,
               device, hook, results):
    try:
        results.put((rank, _rank(rank, world, port, cell, jobs, seconds,
                                 traced, t0_wall, device, hook)))
    except BaseException:                 # the launcher reports it
        results.put((rank, {"error": traceback.format_exc()}))


def _rank(rank, world, port, cell, jobs, seconds, traced, t0_wall,
          device_type, hook):
    import torch.distributed as dist

    from headpose_tpu_torch.parallel import (create_mesh, host_local_batch,
                                             initialize_distributed)

    from ..reference.detector import tf32_mode

    on_card = device_type == "cuda"
    if any(c for _, c in jobs) and cell.config["control"] != "tf32":
        raise ValueError("the mesh runner's control is TF32 switched on; "
                         f"this configuration's is {cell.config['control']}")
    phases = common.Phases(t0_wall, clock=time.time)
    initialize_distributed(f"localhost:{port}", world, rank,
                           local_device_ids=[rank] if on_card else None,
                           backend="nccl" if on_card else "gloo")
    ctl = dist.new_group(backend="gloo")
    if hook:
        module, fn = hook.split(":")
        getattr(importlib.import_module(module), fn)()
    mesh = create_mesh(world, device_type=device_type)
    phases.mark("process_group")
    device = torch.device("cuda", rank) if on_card else torch.device("cpu")
    det = common.detector(cell.config, device, mesh=mesh)
    phases.mark("detector")
    tr = cell.traffic
    images = framegen.corpus(tr)
    B = int(tr["batch"])
    rows = B // world
    copy = torch.cuda.Stream(device) if on_card else None
    depth, every = int(tr["prefetch"]), int(tr["sync_every"])

    def flag(value: float, op) -> float:
        t = torch.tensor([value], dtype=torch.float64)
        dist.all_reduce(t, op=op, group=ctl)
        return float(t[0])

    def steps(ring, count=None, until=None, log=None):
        """Drive steps over `ring`: `count` of them, or until rank 0's clock
        passes `until` (checked every `sync_every` steps, by all ranks
        alike).  `log(k, br, handed)` receives each finished step, oldest
        first."""
        staged, pending = deque(), deque()
        k = 0

        def more():
            if count is not None:
                return k < count
            if k % every:
                return True
            late = rank == 0 and time.perf_counter() >= until
            return flag(1.0 if late else 0.0, dist.ReduceOp.MAX) == 0.0

        def stage_next():
            nonlocal k
            if not more():
                return
            h, handed = ring[k % len(ring)], time.perf_counter()
            if on_card:
                with torch.cuda.stream(copy):
                    h = h.to(device, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(copy)
            staged.append((k, handed, h, ev if on_card else None))
            k += 1

        for _ in range(depth):
            stage_next()
        while staged or pending:
            while staged and len(pending) < depth:
                j, handed, d, ev = staged.popleft()
                if on_card:
                    torch.cuda.current_stream(device).wait_event(ev)
                    d.record_stream(torch.cuda.current_stream(device))
                t = time.perf_counter()
                with torch.profiler.record_function("perfbench.dispatch"):
                    br = det.detect(host_local_batch(mesh, d))
                dispatch.append(time.perf_counter() - t)
                done = None
                if on_card:
                    done = torch.cuda.Event()
                    done.record()
                pending.append((j, handed, br, done))
                stage_next()
            j, handed, br, done = pending.popleft()
            if done is not None and (rank != 0 or traced):
                done.synchronize()
            if log is not None:
                log(j, br, handed)

    dispatch: list = []
    survivors: list = []

    def trim(j, br, handed):
        if rank == 0:
            with torch.profiler.record_function("perfbench.trim"):
                survivors.append(sum(len(r) for r in br.trim()) / world)

    def job(seed: int, control: bool) -> dict:
        host = framegen.ring(tr, seed, images)
        ring = [torch.from_numpy(np.ascontiguousarray(
            f[rank * rows:(rank + 1) * rows])) for f in host]
        phases.mark("frames")
        if on_card:
            ring = [t.pin_memory() for t in ring]
        phases.mark("pin")
        out: dict = {"host": host, "control": control,
                     "setup_phases": phases.spans}
        with tf32_mode(control):
            steps(ring, count=1, log=trim)
            phases.mark("first_batch")
            steps(ring, count=int(tr["warmup_batches"]) - 1, log=trim)
            if on_card:
                torch.cuda.synchronize(device)
            phases.mark("warmup")
            if traced and on_card:
                n = int(tr["profile_batches"])

                def window():
                    survivors.clear()
                    steps(ring, count=n, log=trim)

                plan = dict(cell.config["launches"], all_gather=1)
                out["trace"], out["retakes"], out["launches"] = (
                    common.guarded_profile(
                        window, plan, n, agree=lambda ok: flag(
                            1.0 if ok else 0.0, dist.ReduceOp.MIN) > 0))
                out["survivors"] = (float(np.mean(survivors)) if rank == 0
                                    else 0.0)
                phases.mark("profile")
            dispatch.clear()
            handed_t, done_t, trims = [], [], []
            sample = common.Reservoir(int(tr["check_batches"]), seed)

            def collect(j, br, handed):
                if rank != 0:
                    return
                t = time.perf_counter()
                results = br.trim()
                now = time.perf_counter()
                trims.append(now - t)
                handed_t.append(handed)
                done_t.append(now)
                sample.offer(j % len(ring), results)

            flag(0.0, dist.ReduceOp.MAX)                 # start together
            t_start = time.perf_counter()
            out["setup_s"] = time.time() - t0_wall
            steps(ring, until=t_start + seconds, log=collect)
        if rank == 0:
            wall = done_t[-1] - t_start
            lat = np.asarray(done_t) - np.asarray(handed_t)
            out.update(
                attempted=len(done_t) * B, completed=len(done_t) * B,
                frames_per_s=len(done_t) * B / wall, window_s=wall,
                latency_p95_ms=1e3 * float(np.percentile(lat, 95)),
                sample=sample.kept,
                spans={"dispatch": list(dispatch) if traced else [],
                       "trim": trims if traced else []})
        return out

    outs = [job(seed, control) for seed, control in jobs]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    busy = [trace.busy_us(o["trace"].device) / 1e6 if "trace" in o else 0.0
            for o in outs]
    gathered = [None] * world
    dist.all_gather_object(gathered, (peak, busy), group=ctl)
    del det
    dist.barrier(group=ctl)
    dist.destroy_process_group()
    if rank != 0:
        return []
    if on_card:
        torch.cuda.empty_cache()
    for i, out in enumerate(outs):
        out["memory_peak_bytes"] = max(p for p, _ in gathered)
        out["readings"] = common.reference_check(
            cell, out.pop("host"), out.pop("sample"), device)
        if "trace" in out:
            tr_ = out.pop("trace")
            out["busy_s"] = float(np.mean([b[i] for _, b in gathered]))
            n = int(tr["profile_batches"])
            out["ctx"] = metrics.Context(
                config=cell.config, traffic=tr, chips=world, trace=tr_,
                batches=n, rows=rows, survivors=out["survivors"],
                frames_per_s=n * B / tr_.window_s, busy_s=out["busy_s"],
                frame_hw=framegen.frame_shape(tr, images), spans=out["spans"])
    return outs
