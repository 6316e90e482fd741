"""The multichip dryrun: the multi-device paths of the port end to end.

    python -m headpose_tpu_torch.parallel.dryrun --nproc 4 --device cpu
    python -m headpose_tpu_torch.parallel.dryrun --nproc 2 --device cuda \\
        --backend gloo --same-device          # two ranks sharing one card

Port of `__graft_entry__.dryrun_multichip` and scripts/multihost_worker.py.
The launcher spawns N ranks (`python -m headpose_tpu_torch.parallel.dryrun
--rank R ...`), joined by torch.distributed over localhost; each runs the
parts named by --parts, writes its numbers to <out>/rank<R>.json (rank 0
also the arrays, <out>/rank0.npz) and exits.  The launcher exits non-zero
when a rank fails, when a rank's check misses, or at the timeout.  The
parts, as JAX's three:

  mesh     create_mesh's shapes and refusals; replicate, shard_rows and
           host_local_batch: each rank's part and the whole value;
  train    (1) one training step with the head's hidden weights sharded
           over 'model' (parallel.shard_head_params) and the batch over
           'data', for the mlp (dropout 0.01), se_transformer and
           ensemble families of JAX's dryrun (and the mlp without dropout),
           on the (N/m, m) mesh of m = --model-parallel (unset: each
           mesh of `train_meshes`, JAX's choice, 2 where N is even and
           >= 4, else 1, and then N); the loss and every gradient against the unsharded
           step on the rank (TP_TOL), and every updated parameter within
           TP_TOL plus what Adam's first step makes of the gradient's
           gap; a warm step's time (forward, backward and Adam on a
           persistent optimizer, nothing gathered), sharded and
           unsharded;
  detect   (2) FaceDetector(mesh=...) on an (N, 1) mesh against the
           unsharded detector on the same frames: the flagship at
           "highest" and "fast", under head_eval="survivors" and through
           detect_fused, 'unified-best-distilled' and
           'unified-back-distilled'; valid identical, poses and boxes
           within 1e-5, each window's kernel launches equal, walls
           (sharded, unsharded, and the unsharded detector on the rank's
           own rows alone); the slab's all-gather timed; the
           divisibility error; the batch from host_local_batch;
           tools.aot refusing the mesh detector;
  batcher  rank 0's DynamicBatcher over the mesh detector, the other ranks
           following (runtime.server.follow); frames per dispatch;
  fit      (3) fit(mesh=) on the (N, 1) mesh: data-parallel against the
           same fit without a mesh (at batch 64, and at full batch),
           block mode (epochs_per_sync=3)
           against per-epoch mode, and a run saved, stopped and resumed
           against one that was not; with --rows, also on those rows
           (ROWS_EPOCHS epochs).

The ranks run on the card unless --device cpu; without a card the
launcher raises before it spawns any.  Rank r runs on cuda:r (cuda:0 for
every rank under --same-device); each reports the device it found current
and the collectives it staged through host memory, and `failed_checks`
refuses NCCL ranks that share a device.

Frames: the golden production image rolled (JAX's dryrun), the parity
corpus at --batch (--frames corpus), or an .npz with `frames`.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

PARTS = ("mesh", "train", "detect", "batcher", "fit")
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden")
DETECT_TOL = dict(rtol=1e-5, atol=1e-5)       # __graft_entry__.py:285-290
# the TP step: its loss and every gradient element (abs + rel); every
# parameter after the step within it too, plus the most that Adam's first
# step (lr * g / (|g| + eps)) moves for a gradient within the held gap:
# near |g| = eps another sum order's gap is amplified past 1e-5 (PERF.md §6)
TP_TOL = 1e-5
DP_FIT_RTOL = 1e-4                            # tests/test_parallel.py:52-54
BLOCK_FIT_RTOL = 1e-5                         # tests/test_parallel.py:73-76
SERVE_POSE_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_server.py:96-99
SERVE_BOX_TOL = dict(rtol=1e-5, atol=1e-5)
ROWS_EPOCHS = 5                               # fit on --rows


# ---------------------------------------------------------------- launcher
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(nproc: int, out: str, *, device: str = "cuda",
           backend: str | None = None, same_device: bool = False,
           parts=PARTS, model_parallel: int | None = None,
           frames: str = "production", batch: int | None = None,
           rows: str | None = None, timeout: float = 900.0) -> list[dict]:
    """Spawn the N ranks and wait for them; returns their results (rank
    order).  The ranks run on the card unless device="cpu"; without one
    this raises before spawning.  `model_parallel`: the train part's
    'model' axis size (None: each of `train_meshes`).  Raises RuntimeError when a rank fails or the timeout passes (every
    rank is stopped first)."""
    if device != "cpu":
        from ..utils.device import resolve_device

        resolve_device(None)             # raises without a card
    os.makedirs(out, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    # CPU ranks split the host's cores
    threads = (max(1, (os.cpu_count() or 1) // nproc) if device == "cpu"
               else None)
    port = _free_port()
    cmd = [sys.executable, "-m", "headpose_tpu_torch.parallel.dryrun",
           "--nproc", str(nproc), "--device", device, "--out", out,
           "--port", str(port), "--parts", ",".join(parts),
           "--frames", frames]
    for flag, value in (("--backend", backend),
                        ("--model-parallel", model_parallel),
                        ("--batch", batch), ("--rows", rows),
                        ("--threads", threads)):
        if value is not None:
            cmd += [flag, str(value)]
    if same_device:
        cmd.append("--same-device")
    procs = []
    for r in range(nproc):
        log = open(os.path.join(out, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                                       stdout=log, stderr=subprocess.STDOUT),
                      log))
    deadline = time.monotonic() + timeout
    failed = None
    while any(p.poll() is None for p, _ in procs):
        bad = [r for r, (p, _) in enumerate(procs)
               if p.poll() not in (None, 0)]
        if bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]][0].poll()}"
            break
        if time.monotonic() > deadline:
            failed = f"timeout after {timeout} s"
            break
        time.sleep(0.2)
    for p, log in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()
    if failed is None:
        bad = [r for r, (p, _) in enumerate(procs) if p.returncode]
        if bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]][0].returncode}"
    if failed:
        tails = []
        for r in range(nproc):
            with open(os.path.join(out, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r}\n" + f.read()[-3000:])
        raise RuntimeError(f"dryrun failed: {failed}\n" + "\n".join(tails))
    results = []
    for r in range(nproc):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def failed_checks(results: list[dict]) -> list[str]:
    """The names of the checks that missed, over every rank, and a miss for
    each CUDA device that more than one NCCL rank reports as its own (NCCL
    takes one rank a device)."""
    missed = [f"rank {res['rank']}: {name}" for res in results
              for name, ok in res["checks"].items() if not ok]
    owners: dict[int, list[int]] = {}
    for res in results:
        if res.get("backend") == "nccl" and res.get("cuda_device") is not None:
            owners.setdefault(res["cuda_device"], []).append(res["rank"])
    missed += [f"ranks {ranks}: one device cuda:{d}"
               for d, ranks in sorted(owners.items()) if len(ranks) > 1]
    return missed


def dryrun_multichip(n_devices: int, **kwargs) -> list[dict]:
    """JAX's `dryrun_multichip(n)`: every part on n ranks (on the card by
    default, device="cpu" for the CPU; `launch`'s keywords); raises
    AssertionError naming the checks that missed."""
    out = kwargs.pop("out", None) or tempfile.mkdtemp(prefix="dryrun_")
    results = launch(n_devices, out, **kwargs)
    missed = failed_checks(results)
    if missed:
        raise AssertionError(f"dryrun checks missed: {missed}")
    return results


# ------------------------------------------------------------------ a rank
class _Rank:
    """One rank's state: its mesh helpers, device and report."""

    def __init__(self, args):
        from ..utils.device import resolve_device
        from . import initialize_distributed

        self.args = args
        local = 0 if args.same_device else args.rank
        initialize_distributed(
            f"localhost:{args.port}", args.nproc, args.rank,
            local_device_ids=[local] if args.device == "cuda" else None,
            backend=args.backend)
        self.device = (torch.device("cuda", local) if args.device == "cuda"
                       else torch.device("cpu"))
        if (self.device.type == "cuda"
                and torch.distributed.get_backend() == "gloo"):
            # ranks sharing a card: DTensor's gathers through host memory
            from .distributed import route_gloo_cuda_collectives

            route_gloo_cuda_collectives()
        cuda = self.device.type == "cuda"
        self.report = {"rank": args.rank, "nproc": args.nproc,
                       "device": str(self.device),
                       "cuda_device": (torch.cuda.current_device() if cuda
                                       else None),
                       "backend": torch.distributed.get_backend(),
                       "checks": {}}
        if cuda:
            # the rank's tensors, streams and kernel launches on its card
            self.check("device[current]", self.report["cuda_device"] == local
                       and resolve_device(None) == self.device)
        self.arrays: dict[str, np.ndarray] = {}
        self.meshes: dict = {}

    def mesh(self, model_parallel: int = 1):
        """The (N/m, m) mesh, made once (a mesh makes its process groups)."""
        from . import create_mesh

        if model_parallel not in self.meshes:
            self.meshes[model_parallel] = create_mesh(
                self.args.nproc, model_parallel=model_parallel,
                device_type=self.device.type)
        return self.meshes[model_parallel]

    def check(self, name: str, ok: bool) -> None:
        self.report["checks"][name] = bool(ok)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _allclose(a, b, rtol: float, atol: float) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(np.all(np.abs(a - b)
                                              <= atol + rtol * np.abs(b)))


# ------------------------------------------------------------------- mesh
def part_mesh(rank: _Rank) -> None:
    from . import create_mesh, host_local_batch, replicate, shard_rows

    n, r = rank.args.nproc, rank.args.rank
    out = {"shape": list(rank.mesh(1).mesh.shape)}
    if n % 2 == 0:
        out["shape_model_parallel_2"] = list(rank.mesh(2).mesh.shape)
    if n > 2:
        out[f"shape_model_parallel_{n}"] = list(rank.mesh(n).mesh.shape)
    for name, kw in (("too_many", dict(n_devices=2 * n)),
                     ("indivisible", dict(n_devices=n, model_parallel=3))):
        try:
            create_mesh(device_type=rank.device.type, **kw)
            out[f"error_{name}"] = None
        except ValueError as e:
            out[f"error_{name}"] = str(e)
    rank.check("mesh[refusals]", out["error_too_many"] is not None and (
        n % 3 == 0 or out["error_indivisible"] is not None))
    mesh = rank.mesh(1)
    x = torch.arange(8 * n * 3, dtype=torch.float32).reshape(8 * n, 3)
    rows = slice(8 * r, 8 * r + 8)
    rep, sh = replicate({"x": x}, mesh)["x"], shard_rows(x, mesh)
    via = host_local_batch(mesh, x[rows].numpy())
    rank.check("mesh[replicate]", torch.equal(rep.to_local().cpu(), x)
               and torch.equal(rep.full_tensor().cpu(), x))
    rank.check("mesh[shard_rows]", torch.equal(sh.to_local().cpu(), x[rows])
               and torch.equal(sh.full_tensor().cpu(), x))
    rank.check("mesh[host_local_batch]", tuple(via.shape) == tuple(x.shape)
               and torch.equal(via.to_local().cpu(), x[rows])
               and torch.equal(via.full_tensor().cpu(), x))
    rank.report["mesh"] = out


# ------------------------------------------------------------ (1) tp step
def tp_cases(n: int):
    """JAX's dryrun families, each (name, spec, params, batch): params from
    `spec.init(torch.Generator().manual_seed(0))` (JAX layout), a batch of
    8n rows from numpy's default_rng(0), drawn in this order."""
    from ..models.heads import EnsembleHead, MLPHead, SEMLPHead, \
        SETransformerHead

    batch = 8 * n
    rng = np.random.default_rng(0)
    cases = []
    for name, spec in (
            ("mlp", MLPHead(96, ((64, "tanh"), (3, "linear")),
                            dropout_rate=0.01)),
            ("se_transformer", SETransformerHead(in_features=96, hidden=64)),
            ("ensemble", EnsembleHead(members=(
                MLPHead(96, ((64, "tanh"), (3, "linear"))),
                SEMLPHead(in_features=96)))),
            ("mlp_no_dropout", MLPHead(96, ((64, "tanh"), (3, "linear"))))):
        params = spec.init(torch.Generator().manual_seed(0))
        data = {"x": rng.normal(size=(batch, 96)).astype(np.float32),
                "y": rng.normal(size=(batch, 3)).astype(np.float32),
                "w": np.ones((batch,), np.float32),
                "mask": np.ones((batch,), np.float32)}
        cases.append((name, spec, params, data))
    return cases


TP_LR, TP_REG, TP_SEED = 2.8e-4, 1e-6, 1      # JAX's dryrun step


def adam_slack(g_ref: torch.Tensor, gap: torch.Tensor) -> torch.Tensor:
    """Per element, the most by which Adam's first step (lr * g / (|g| +
    eps), train.loop.HeadOptimizer) moves a parameter when its gradient
    lies within `gap` of `g_ref` (the step is monotone in g, so at an end
    of the interval).  float64."""
    from ..train.loop import HeadOptimizer

    def step(g):
        return TP_LR * g / (g.abs() + HeadOptimizer.EPS)

    g, d = g_ref.double(), gap.double()
    return torch.maximum((step(g + d) - step(g)).abs(),
                         (step(g - d) - step(g)).abs())


def params_held(got: torch.Tensor, want: torch.Tensor, g_got: torch.Tensor,
                g_want: torch.Tensor) -> tuple[bool, int, float]:
    """The updated parameters of the sharded step (`got`) against the
    unsharded step's (`want`), element by element: within TP_TOL (abs +
    rel) plus `adam_slack` of the two steps' gradient gap.  Returns (every
    element held, the number that needed more than TP_TOL, the largest
    unsharded |gradient| among those)."""
    got, want = got.double().cpu(), want.double().cpu()
    err = (got - want).abs()
    tol = TP_TOL + TP_TOL * want.abs()
    slack = adam_slack(g_want.cpu(), (g_got - g_want).abs().cpu())
    past = err > tol
    return (bool((err <= tol + slack).all()), int(past.sum()),
            float(g_want.cpu().abs()[past].max()) if past.any() else 0.0)


def train_step(net, batch, generator_device):
    """One Adam step of JAX's dryrun (`_loss_and_metrics(..., 1e-6,
    True)`, adam(2.8e-4, eps=1e-7)) on `net`, its parameters plain or
    DTensors → (loss, mae, the gradients by name) as plain tensors."""
    from torch.distributed.tensor import DTensor

    opt, generator = step_state(net, generator_device)
    loss, mae = backward(net, opt, batch, generator)
    with torch.no_grad():
        grads = {k: (p.grad.full_tensor() if isinstance(p.grad, DTensor)
                     else p.grad.clone()) for k, p in net.named_parameters()}
    opt.step()
    return loss.detach(), mae.detach(), grads


def step_state(net, generator_device):
    """`train_step`'s optimizer over `net` and its dropout generator."""
    from ..train.loop import HeadOptimizer

    return (HeadOptimizer(list(net.parameters()), "adam", TP_LR),
            torch.Generator(device=generator_device).manual_seed(TP_SEED))


def backward(net, opt, batch, generator):
    """The step's forward and backward on `net`, each gradient left in its
    parameter's placements (a replicated weight's partial sums summed) →
    (loss, mae); `opt.step()` completes the step."""
    from ..train.loop import _loss_and_metrics

    from torch.distributed.tensor import DTensor, Replicate

    def whole(t):
        # a scalar DTensor (partial sums) replicated, differentiably
        if not isinstance(t, DTensor):
            return t
        mesh = t.device_mesh
        return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()

    loss, mae = _loss_and_metrics(net, batch, generator, TP_REG)
    loss, mae = whole(loss), whole(mae)
    opt.zero_grad()
    loss.backward()
    with torch.no_grad():
        for p in net.parameters():  # a replicated weight's gradient: summed
            if isinstance(p.grad, DTensor) and (p.grad.placements
                                                != p.placements):
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
    return loss.detach(), mae.detach()


def warm_step_s(rank: _Rank, net, batch) -> float:
    """Median seconds of the step once warm (`_wall`): forward, backward
    and Adam on one persistent optimizer, no gradient gathered whole.  It
    moves `net`'s parameters."""
    opt, generator = step_state(net, rank.device)

    def step():
        backward(net, opt, batch, generator)
        opt.step()

    step()                          # the optimizer's state made
    return _wall(rank, step)


def train_meshes(n: int) -> tuple[int, ...]:
    """The train part's 'model' axis sizes when none is asked for: JAX's
    dryrun's choice (2 where N is even and >= 4, else 1), then N (every
    rank on 'model')."""
    return tuple(dict.fromkeys((2 if n % 2 == 0 and n >= 4 else 1, n)))


def part_train(rank: _Rank) -> None:
    """The TP step on the mesh of --model-parallel, or on each of
    `train_meshes` where it is unset: the first mesh's
    report is `train` (checks `train[<family>]`, arrays `train/...`), each
    other's under its shape "<data>x<model>" (checks `train[<family>]@1x4`,
    arrays `train@1x4/...`); `train_meshes` holds them all."""
    n = rank.args.nproc
    meshes = {}
    mps = rank.args.model_parallel
    for i, mp in enumerate((mps,) if mps else train_meshes(n)):
        shape = f"{n // mp}x{mp}"
        meshes[shape] = _train_on(rank, mp, "" if i == 0 else f"@{shape}")
        if i == 0:
            rank.report["train"] = meshes[shape]
    rank.report["train_meshes"] = meshes


def _train_on(rank: _Rank, mp: int, suffix: str) -> dict:
    from ..models.heads import head_net
    from ..models.params import (flatten_params, params_from_jax,
                                 params_to_jax)
    from .mesh import MODEL_AXIS, axis_size, shard_head_params, shard_rows

    n = rank.args.nproc
    mesh = rank.mesh(mp)
    out = {"mesh": [n // mp, mp]}
    for name, spec, params, data in tp_cases(n):
        t0 = time.perf_counter()
        net = shard_head_params(spec, params, mesh)
        sharded = sum(1 for p in net.parameters() if any(
            not pl.is_replicate() for pl in p.placements))
        batch = shard_rows({k: torch.from_numpy(v) for k, v in data.items()},
                           mesh)
        loss, mae, grads = train_step(net, batch, rank.device)
        got = {k: p.detach().full_tensor() for k, p in
               net.named_parameters()}
        rank.sync()
        t_tp = time.perf_counter() - t0
        ref = head_net(spec, device=rank.device)
        ref.load_state_dict(params_from_jax(spec, params))
        local = {k: torch.from_numpy(v).to(rank.device)
                 for k, v in data.items()}
        ref_loss, ref_mae, ref_grads = train_step(ref, local, rank.device)
        want = {k: p.detach() for k, p in ref.named_parameters()}
        errs = {k: float((got[k] - want[k]).abs().max()) for k in got}
        worst = max(errs, key=errs.get)
        grad_err = max(float((grads[k] - ref_grads[k]).abs().max())
                       for k in grads)
        held = {k: params_held(got[k], want[k], grads[k], ref_grads[k])
                for k in got}
        ok = (all(_allclose(grads[k].cpu(), ref_grads[k].cpu(), TP_TOL,
                            TP_TOL) for k in grads)
              and _allclose(float(loss), float(ref_loss), TP_TOL, TP_TOL)
              and all(h[0] for h in held.values()))
        rank.check(f"train[{name}]{suffix}", ok and (
            sharded > 0 or axis_size(mesh, MODEL_AXIS) == 1))
        out[name] = {"loss": float(loss), "mae": float(mae),
                     "loss_unsharded": float(ref_loss),
                     "max_param_err": errs[worst], "worst_param": worst,
                     # name: [elements past TP_TOL, their largest |g|]
                     "params_past_tol": {k: [n, g] for k, (_, n, g)
                                         in held.items() if n},
                     "max_grad_err": grad_err,
                     "sharded_params": sharded,
                     "step_s": t_tp}
        flat = flatten_params(params_to_jax(spec, {
            k: v.cpu() for k, v in got.items()}))
        for k, v in flat.items():
            rank.arrays[f"train{suffix}/{name}/{k}"] = np.array(v)  # a copy
        rank.arrays[f"train{suffix}/{name}/loss"] = np.float32(float(loss))
        # warm steps, sharded and unsharded; they move the parameters,
        # which `got` and `want` may share
        step_s = warm_step_s(rank, net, batch)
        step_s_ref = warm_step_s(rank, ref, local)
        out[name]["warm_step_ms"] = step_s * 1e3
        out[name]["warm_step_ms_unsharded"] = step_s_ref * 1e3
        print(f"dryrun[{name}]: mesh={out['mesh']} loss={float(loss):.6f} "
              f"(unsharded {float(ref_loss):.6f}) max gradient err "
              f"{grad_err:.3g}, max param err {errs[worst]:.3g} ({worst}; "
              f"past {TP_TOL:g} within Adam's slack: "
              f"{out[name]['params_past_tol']}), warm step "
              f"{step_s * 1e3:.3f} ms (unsharded {step_s_ref * 1e3:.3f})",
              flush=True)
    return out


# ------------------------------------------------------------- (2) detect
def dryrun_frames(kind: str, batch: int | None, n: int) -> np.ndarray:
    """The frames of the detect part: 'production' (the golden production
    image rolled by i pixels, JAX's dryrun), 'corpus' (the parity corpus,
    repeated to `batch`), or an .npz path holding `frames`."""
    if kind == "production":
        img = np.load(os.path.join(GOLDEN, "e2e_production.npz"))["img"]
        b = batch or max(8, n)
        return np.stack([np.roll(img, i, axis=1) for i in range(b)])
    if kind == "corpus":
        imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"]
        b = batch or len(imgs)
        return np.concatenate([imgs] * (-(-b // len(imgs))))[:b]
    with np.load(kind) as f:
        frames = f["frames"]
    return frames[:batch] if batch else frames


def _wall(rank: _Rank, fn, reps: int = 3) -> float:
    """Median wall seconds of fn() (synchronised) on this rank."""
    walls = []
    for _ in range(reps):
        rank.sync()
        t0 = time.perf_counter()
        fn()
        rank.sync()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def _collective_ms(rank: _Rank, fn, reps: int = 10) -> float:
    """Median milliseconds of fn(), each call started after a barrier of
    every rank: CUDA events on the card, the host clock on the CPU."""
    times = []
    for _ in range(reps):
        torch.distributed.barrier()
        if rank.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def part_detect(rank: _Rank) -> None:
    import warnings

    from ..ops.kernels import library
    from ..pretrained import load_pretrained
    from ..runtime.detector import FaceDetector
    from . import host_local_batch
    from .distributed import all_gather_rows

    n = rank.args.nproc
    mesh = rank.mesh(1)
    frames = dryrun_frames(rank.args.frames, rank.args.batch, n)
    rank.arrays["detect/frames"] = frames
    dev = rank.device
    rows = frames.shape[0] // n         # this rank's rows
    mine = slice(rank.args.rank * rows, (rank.args.rank + 1) * rows)
    flagship = load_pretrained("unified-stoqa9pt-hrchr82r")
    best = load_pretrained("unified-best-distilled")
    with warnings.catch_warnings():        # a synthetic bring-up model
        warnings.simplefilter("ignore")
        back = load_pretrained("unified-back-distilled")
    variants = (("flagship", flagship, {}, "detect"),
                ("flagship_fast", flagship, {"precision": "fast"}, "detect"),
                ("flagship_survivors", flagship, {"head_eval": "survivors"},
                 "detect"),
                ("flagship_fused", flagship, {}, "detect_fused"),
                ("best_distilled", best, {"precision": "fast"}, "detect"),
                ("back", back, {}, "detect"))
    out = {"frames": list(frames.shape), "mesh": [n, 1]}
    staged = torch.from_numpy(frames).to(dev)
    staged_mine = staged[mine]
    for name, (model, params), kw, method in variants:
        det = FaceDetector(model, params, mesh=mesh, **kw)
        plain = FaceDetector(model, params, device=dev, **kw)
        run = getattr(det, method)
        run_plain = getattr(plain, method)
        run(frames[:n])                     # warm (builds, plans)
        run_plain(frames[:n])
        rank.sync()
        library.reset_launches()
        got = run(staged)
        rank.sync()
        launches = library.launches()
        library.reset_launches()
        want = run_plain(staged)
        rank.sync()
        launches_plain = library.launches()
        g = {f: getattr(got, f).cpu().numpy() for f in
             ("valid", "poses", "boxes", "scores")}
        w = {f: getattr(want, f).cpu().numpy() for f in
             ("valid", "poses", "boxes", "scores")}
        m = w["valid"].astype(bool)
        ok = (np.array_equal(g["valid"], w["valid"]) and m.any()
              and _allclose(g["poses"][m], w["poses"][m], **DETECT_TOL)
              and _allclose(g["boxes"][m], w["boxes"][m], **DETECT_TOL))
        bitwise = all(np.array_equal(g[f], w[f]) for f in g)
        rank.check(f"detect[{name}]", ok)
        # each rank runs the whole pipeline once, on its rows
        rank.check(f"detect[{name}].launches", launches == launches_plain)
        if n == 1:
            rank.check(f"detect[{name}].bitwise", bitwise)
        out[name] = {
            "detections": int(m.sum()), "bitwise": bitwise,
            "pose_max_abs_diff": float(np.abs(g["poses"][m]
                                              - w["poses"][m]).max()),
            "launches_window": {k: v for k, v in launches.items() if v},
            "launches_unsharded": {k: v for k, v in launches_plain.items()
                                   if v},
            "wall_s": _wall(rank, lambda: run(staged).slab),
            "wall_unsharded_s": _wall(rank, lambda: run_plain(staged).slab)}
        run_plain(staged_mine)              # the rank's rows alone: warm
        out[name]["wall_local_rows_s"] = _wall(
            rank, lambda: run_plain(staged_mine).slab)
        for f in g:
            rank.arrays[f"detect/{name}/{f}"] = g[f]
        print(f"dryrun[detect:{name}]: {int(m.sum())} detections over "
              f"{n} ranks, sharded == unsharded: {ok} (bitwise {bitwise})",
              flush=True)
        if name == "flagship":
            # the slab's gather over 'data' alone, on this rank's slab
            slab = got.slab[mine].contiguous()
            group = mesh.get_group("data")
            out["all_gather_rows_ms"] = _collective_ms(
                rank, lambda: all_gather_rows(slab, group))
            out["all_gather_rows_bytes"] = slab.numel() * slab.element_size()
            # the batch as this rank's rows (host_local_batch), the
            # granularity and JAX's divisibility error, on every rank
            via = det.detect(host_local_batch(mesh, frames[mine]))
            rank.check("detect[host_local_batch]", torch.equal(
                via.slab.cpu(), got.slab.cpu()))
            out["batch_granularity"] = det.batch_granularity
            rank.check("batch_granularity", det.batch_granularity == n)
            from ..tools.aot import export_detector
            try:
                export_detector(det, os.path.join(rank.args.out, "aot"))
                out["aot_error"] = None
            except ValueError as e:
                out["aot_error"] = str(e)
            rank.check("detect[aot_refused]", out["aot_error"] is not None)
            if n > 1:
                try:
                    det.detect(frames[:n + 1])
                    message = None
                except ValueError as e:
                    message = str(e)
                out["indivisible_error"] = message
                rank.check("detect[indivisible]", message is not None
                           and "does not divide" in message)
    rank.report["detect"] = out


# ------------------------------------------------------------ batcher part
def part_batcher(rank: _Rank) -> None:
    from ..pretrained import load_pretrained
    from ..runtime.detector import FaceDetector
    from ..runtime.server import DynamicBatcher, follow

    n = rank.args.nproc
    mesh = rank.mesh(1)
    model, params = load_pretrained("unified-stoqa9pt-hrchr82r")
    det = FaceDetector(model, params, score_threshold=0.05, mesh=mesh)
    frames = dryrun_frames("production", 3, n)
    if rank.args.rank != 0:
        rank.report["batcher"] = {"followed": follow(det)}
        rank.check("batcher[follow]", rank.report["batcher"]["followed"] >= 1)
        return
    plain = FaceDetector(model, params, score_threshold=0.05,
                         device=rank.device)
    want = plain.detect(frames).trim()
    with DynamicBatcher(det, max_batch=12, max_delay=0.05) as b:
        widths = b.widths
        futs = [b.submit(f) for f in frames]
        got = [fut.result(timeout=300) for fut in futs]
        served, dispatches = b.frames_served, b.dispatches
    ok = served == 3 and all(
        len(g.poses) == len(w.poses)
        and _allclose(g.poses, w.poses, **SERVE_POSE_TOL)
        and _allclose(g.boxes, w.boxes, **SERVE_BOX_TOL)
        for g, w in zip(got, want))
    expect = [n]
    while expect[-1] * 2 < 12:
        expect.append(expect[-1] * 2)
    expect.append(-(-12 // n) * n)
    rank.check("batcher[widths]", list(widths) == expect)
    rank.check("batcher[answers]", ok)
    rank.report["batcher"] = {"widths": list(widths), "frames_served": served,
                              "dispatches": dispatches,
                              "frames_per_dispatch": served / max(1, dispatches),
                              "detections": [len(g.poses) for g in got]}
    print(f"dryrun[batcher]: widths {widths}, 3 frames in {dispatches} "
          f"dispatches answered as plain detect: {ok}", flush=True)


# ----------------------------------------------------------------- (3) fit
def fit_datasets():
    """The fit part's rows: the linear problems of JAX's
    tests/test_parallel.py, 256 rows x 16 features from default_rng(0) and
    (1), and one of 320 rows from (2), whose 256 training rows are one
    batch (a run that does not depend on the row order)."""
    from ..data import Dataset

    out = []
    for seed, rows in ((0, 256), (1, 256), (2, 320)):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(rows, 16)).astype(np.float32)
        w = rng.normal(size=(16, 3)).astype(np.float32)
        out.append(Dataset(x, x @ w))
    return out


def _history(res) -> np.ndarray:
    return np.array([[h["train_loss"], h["val_loss"]] for h in res.history])


def part_fit(rank: _Rank) -> None:
    from ..data import load_dataset
    from ..train import config_96, fit

    n = rank.args.nproc
    mesh = rank.mesh(1)
    ckpt = os.path.join(rank.args.out, "ckpt")   # the same on every rank
    dev = rank.device
    ds0, ds1, ds2 = fit_datasets()
    out = {}
    for name, ds, batch in (("dp", ds0, 64), ("dp_full_batch", ds2, 256)):
        cfg = config_96(in_features=16, num_filters=8, total_epochs=3,
                        batch_size=batch, checkpoint_dir=ckpt)
        t0 = time.perf_counter()
        r_mesh = fit(cfg.replace(run_name=f"{name}_mesh"), ds, mesh=mesh)
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        r_one = fit(cfg.replace(run_name=f"{name}_one"), ds, device=dev)
        t_one = time.perf_counter() - t0
        a, b = _history(r_mesh), _history(r_one)
        rank.check(f"fit[{name}]", _allclose(a, b, DP_FIT_RTOL, 0.0))
        out[name] = {"history": a.tolist(),
                     "history_one_process": b.tolist(),
                     "max_rel": float(np.abs(a / b - 1).max()),
                     "bitwise": bool(np.array_equal(a, b)), "wall_s": t_mesh,
                     "wall_one_process_s": t_one}
        rank.arrays[f"fit/{name}"] = a

    cfg = config_96(in_features=16, num_filters=8, total_epochs=5,
                    batch_size=64, checkpoint_dir=ckpt)
    r1 = fit(cfg.replace(run_name="per_epoch"), ds1, mesh=mesh)
    rk = fit(cfg.replace(run_name="block", epochs_per_sync=3), ds1,
             mesh=mesh)
    a, b = _history(rk), _history(r1)
    rank.check("fit[block]", _allclose(a, b, BLOCK_FIT_RTOL, 0.0))
    out["block"] = {"history": a.tolist(), "history_per_epoch": b.tolist(),
                    "max_rel": float(np.abs(a / b - 1).max())}
    rank.arrays["fit/block"] = a

    # saved after 2 of 4 epochs, resumed: the same history as one run
    cfg = config_96(in_features=16, num_filters=8, total_epochs=4,
                    batch_size=64, checkpoint_dir=ckpt)
    whole = fit(cfg.replace(run_name="whole"), ds0, mesh=mesh)
    first = fit(cfg.replace(run_name="resumed", total_epochs=2), ds0,
                mesh=mesh)
    rest = fit(cfg.replace(run_name="resumed"), ds0, mesh=mesh, resume=True)
    a = np.concatenate([_history(first), _history(rest)])
    b = _history(whole)
    rank.check("fit[resume]", _allclose(a, b, BLOCK_FIT_RTOL, 0.0))
    out["resume"] = {"history": a.tolist(), "history_whole": b.tolist(),
                     "resumed_at": rest.history[0]["epoch"]
                     if rest.history else None}

    if rank.args.rows:
        ds = load_dataset(rank.args.rows)
        cfg = config_96(total_epochs=ROWS_EPOCHS, seed=0,
                        checkpoint_dir=ckpt)
        rank.sync()
        t0 = time.perf_counter()
        r_mesh = fit(cfg.replace(run_name="rows_mesh"), ds, mesh=mesh)
        rank.sync()
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        r_one = fit(cfg.replace(run_name="rows_one"), ds, device=dev)
        rank.sync()
        t_one = time.perf_counter() - t0
        a, b = _history(r_mesh), _history(r_one)
        rtol = BLOCK_FIT_RTOL if n == 1 else DP_FIT_RTOL
        rank.check("fit[rows]", _allclose(a, b, rtol, 0.0))
        out["rows"] = {"rows": len(ds), "epochs": len(a),
                       "max_rel": float(np.abs(a / b - 1).max()),
                       "rtol": rtol, "bitwise": bool(np.array_equal(a, b)),
                       "epoch_ms": t_mesh * 1e3 / max(1, len(a)),
                       "epoch_ms_one_process": t_one * 1e3 / max(1, len(b))}
    rank.report["fit"] = out
    print(f"dryrun[fit]: dp vs one process max rel "
          f"{out['dp']['max_rel']:.3g}, block vs per-epoch "
          f"{out['block']['max_rel']:.3g}", flush=True)


# -------------------------------------------------------------------- main
def _worker(args) -> int:
    if args.threads:
        torch.set_num_threads(args.threads)
    rank = _Rank(args)
    parts = {"mesh": part_mesh, "train": part_train, "detect": part_detect,
             "batcher": part_batcher, "fit": part_fit}
    t_all = time.perf_counter()
    for name in args.parts.split(","):
        t0 = time.perf_counter()
        parts[name](rank)
        rank.report.setdefault("part_s", {})[name] = time.perf_counter() - t0
    rank.report["total_s"] = time.perf_counter() - t_all
    from .distributed import HOST_STAGED

    rank.report["host_staged"] = sorted(HOST_STAGED)
    if rank.report["backend"] == "nccl":
        # NCCL takes CUDA tensors: nothing goes through host memory
        rank.check("nccl[not_host_staged]", not HOST_STAGED)
    torch.distributed.barrier()
    if args.rank == 0:
        np.savez(os.path.join(args.out, "rank0.npz"), **rank.arrays)
    path = os.path.join(args.out, f"rank{args.rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(rank.report, f)
    os.replace(path + ".tmp", path)
    torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="default: the card (raises without one)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--same-device", action="store_true",
                    help="every rank on cuda:0 (needs --backend gloo)")
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="the train part's 'model' axis size (default: "
                         "each of JAX's choice and N)")
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--frames", default="production",
                    help="production, corpus, or an .npz with `frames`")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--rows", default=None,
                    help="an .npz dataset the fit part also trains on")
    ap.add_argument("--out", default=None,
                    help="results directory (default: a temporary one)")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--threads", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.same_device and args.backend != "gloo":
        ap.error("--same-device needs --backend gloo (NCCL refuses two "
                 "ranks on one device)")
    if args.rank is not None:
        try:
            return _worker(args)
        except Exception:
            traceback.print_exc()
            sys.stdout.flush()
            os._exit(1)          # the other ranks may wait in a collective
    out = args.out or tempfile.mkdtemp(prefix="dryrun_")
    results = launch(args.nproc, out, device=args.device,
                     backend=args.backend, same_device=args.same_device,
                     parts=tuple(args.parts.split(",")),
                     model_parallel=args.model_parallel, frames=args.frames,
                     batch=args.batch, rows=args.rows, timeout=args.timeout)
    missed = failed_checks(results)
    print(json.dumps({"dryrun": {"nproc": args.nproc, "out": out,
                                 "ranks": results, "missed": missed}}),
          flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
