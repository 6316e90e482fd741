"""Head training, PyTorch edition: Keras semantics on PyTorch autograd.

Port of headpose_tpu/train/loop.py.  No TPU kernel of the JAX package has
a backward, and JAX trains its heads through XLA autograd of `spec.apply`,
so the port trains the head modules (`models.heads`) through autograd.

Keras semantics, as the JAX loop has them:
  * the loss is the MSE over the angles, reduced SUM_OVER_BATCH_SIZE:
    sum(w_i · mse_i) / (real rows of the batch), with the optional
    difficulty weights w; the MAE metric is unweighted; the reported loss
    includes the L2 term (Keras regularizers are loss terms, not decoupled
    weight decay);
  * SGD, Adam and Adamax with Keras's defaults (Adam/Adamax eps 1e-7) in
    optax's arithmetic (`HeadOptimizer`);
  * EarlyStopping(patience, min_delta, restore_best_weights) on
    `monitor_metric`, ReduceLROnPlateau, and a NaN guard that rolls back
    to the best weights with a fresh optimizer (keeping a reduced lr); the
    4th recovery stops the run.

The bookkeeping of early stopping, the plateau schedule and the NaN guard
is kept in device tensors, and the host reads it once every
`epochs_per_sync` epochs (one read per epoch at the default 1): a block of
epochs runs without a device→host copy.  Trailing epochs past
`total_epochs` are not run.

Randomness comes from explicit generators derived from (seed, epoch), so a
resumed run continues the interrupted one exactly: each epoch's row order
is `torch.randperm` from a CPU generator (the same rows on every device,
gathered on the device), and the dropout masks are drawn on the device
from a generator of its own.

Entry points run on the card (`device=None`) unless the caller passes
`device="cpu"`; matrix products run in fp32 with TF32 off.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from ..data.datasets import Dataset
from ..models.blazeface import fp32_exact
from ..models.heads import HEAD_REGISTRY, MLPHead, head_net
from ..tools.convert import params_from_jax, params_to_jax
from ..utils.device import resolve_device
from .checkpoints import restore_checkpoint, save_checkpoint, save_pytree
from .config import TrainConfig
from .logging import MetricLogger, new_run_id

__all__ = ["build_head", "make_optimizer", "HeadOptimizer", "fit",
           "TrainResult", "evaluate"]


def build_head(cfg: TrainConfig):
    """A head spec from the config (the model switch of the reference's
    train_88.py / train_96.py)."""
    if cfg.head == "mlp":
        return MLPHead(cfg.in_features,
                       ((cfg.num_filters, cfg.activation), (3, "linear")),
                       dropout_rate=cfg.dropout_rate)
    if cfg.head == "ensemble":
        raise ValueError(
            "head='ensemble' is not buildable from TrainConfig alone "
            "(members are full head specs); construct models.EnsembleHead "
            "directly and pass it via fit(cfg, ds, spec=...)")
    cls = HEAD_REGISTRY[cfg.head]
    kwargs: dict[str, Any] = {"in_features": cfg.in_features}
    if cfg.head in ("residual_mlp", "skip_mlp"):
        kwargs.update(activation=cfg.activation, dropout_rate=cfg.dropout_rate)
    return cls(**kwargs)


class HeadOptimizer(torch.optim.Optimizer):
    """SGD, Adam or Adamax with Keras's defaults (b1 0.9, b2 0.999, eps
    1e-7; torch's own Adam uses 1e-8), computed in optax's order as the JAX
    package's `make_optimizer` steps:

      sgd     p += g · (-lr)
      adam    mu = 0.1 g + 0.9 mu;  nu = 0.001 g² + 0.999 nu;  t += 1
              p += (mu / (1 - 0.9^t)) / (sqrt(nu / (1 - 0.999^t)) + eps)
                   · (-lr)
      adamax  mu as adam;  nu = max(|g| + eps, 0.999 nu)
              p += (mu / (1 - 0.9^t)) / nu · (-lr)

    The learning rate is a 0-d tensor in the param group (ReduceLROnPlateau
    writes it there), and the step count and moments are tensors on the
    params' device: nothing in a step reads the device back."""

    KINDS = ("sgd", "adam", "adamax")
    B1, B2, EPS = 0.9, 0.999, 1e-7

    def __init__(self, params, kind: str, lr: float):
        if kind not in self.KINDS:
            raise ValueError(f"unknown optimizer {kind!r}")
        params = list(params)
        device = params[0].device
        super().__init__(params, {"lr": torch.tensor(
            lr, dtype=torch.float32, device=device)})
        self.kind = kind
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        moments = [] if kind == "sgd" else params
        self.mu = [torch.zeros_like(p) for p in moments]
        self.nu = [torch.zeros_like(p) for p in moments]

    @property
    def lr(self) -> torch.Tensor:
        return self.param_groups[0]["lr"]

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter from its .grad.  Each line is one
        `torch._foreach_*` op over all parameters (one launch a line on the
        card instead of one a parameter), elementwise as written above."""
        params = self.param_groups[0]["params"]
        grads = [p.grad for p in params]
        neg_lr = -self.lr
        if self.kind == "sgd":
            torch._foreach_add_(params, torch._foreach_mul(grads, neg_lr))
            return
        self.count.add_(1)
        t = self.count.to(torch.float32)
        bc1 = 1.0 - torch.pow(self.B1, t)
        bc2 = 1.0 - torch.pow(self.B2, t)
        torch._foreach_mul_(self.mu, self.B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - self.B1))
        if self.kind == "adam":
            torch._foreach_mul_(self.nu, self.B2)
            torch._foreach_add_(self.nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1.0 - self.B2))
            denom = torch._foreach_div(self.nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.EPS)
        else:
            torch._foreach_mul_(self.nu, self.B2)
            torch._foreach_maximum_(self.nu, torch._foreach_add(
                torch._foreach_abs(grads), self.EPS))
            denom = self.nu
        u = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_mul_(u, neg_lr)
        torch._foreach_add_(params, u)

    def state_tensors(self) -> list[torch.Tensor]:
        """Every tensor of the state: lr, count, the moments."""
        return [self.lr, self.count, *self.mu, *self.nu]

    def state_tree(self) -> dict[str, Any]:
        return {"lr": self.lr, "count": self.count, "mu": self.mu,
                "nu": self.nu}

    @torch.no_grad()
    def load_state_tree(self, tree: dict[str, Any]) -> None:
        """Load what `state_tree` gave (numpy or tensors, e.g. from a
        checkpoint)."""
        def put(dst, src):
            dst.copy_(torch.as_tensor(np.asarray(src)).to(dst.dtype))

        put(self.lr, tree["lr"])
        put(self.count, tree["count"])
        for name in ("mu", "nu"):
            for dst, src in zip(getattr(self, name), tree.get(name, [])):
                put(dst, src)


def make_optimizer(cfg: TrainConfig, params) -> HeadOptimizer:
    """The Keras-matching optimizer of the reference trainers for `params`
    (train_96.py:99-103, train_88.py:323)."""
    return HeadOptimizer(params, cfg.optimizer, cfg.learning_rate)


def _pad_dataset(ds: Dataset, multiple: int,
                 device: torch.device) -> dict[str, torch.Tensor]:
    """Rows padded to a multiple of the batch size; `mask` marks the real
    rows, `w` their weights (1 without difficulty weights)."""
    n = len(ds)
    n_pad = (-n) % multiple
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(n_pad, np.float32)])
    x = np.concatenate([ds.features, np.zeros((n_pad, ds.num_features),
                                              np.float32)])
    y = np.concatenate([ds.poses, np.zeros((n_pad, 3), np.float32)])
    w = mask.copy()
    if ds.weights is not None:
        w[:n] = ds.weights
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in (("x", x), ("y", y), ("w", w), ("mask", mask))}


def _loss_and_metrics(net, batch, generator, reg_rate: float):
    """(loss, mae) of one batch: the Keras weighted MSE over the real rows
    plus the L2 term, and the unweighted MAE."""
    pred = net(batch["x"], generator)
    err = pred - batch["y"]
    per_sample_mse = err.square().mean(dim=-1)
    per_sample_mae = err.abs().mean(dim=-1)
    denom = batch["mask"].sum().clamp(min=1e-9)
    mse = (per_sample_mse * batch["w"]).sum() / denom
    mae = (per_sample_mae * batch["mask"]).sum() / denom
    return mse + net.l2_penalty(reg_rate), mae


def _epoch_seed(seed: int, epoch: int, stream: int) -> int:
    """A generator seed for one epoch's stream (0 the row order, 1 the
    dropout masks), a function of (seed, epoch) only."""
    state = np.random.SeedSequence([seed, epoch, stream]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _permutation(seed: int, epoch: int, n: int,
                 device: torch.device) -> torch.Tensor:
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(
        _epoch_seed(seed, epoch, 0)))
    if device.type == "cuda":
        perm = perm.pin_memory()
    return perm.to(device, non_blocking=True)


def _train_epoch(net, opt: HeadOptimizer, data, perm, generator,
                 batch_size: int, reg_rate: float):
    """One pass over the rows in `perm`'s order, a step a batch → (mean
    batch loss, mean batch mae) as device tensors."""
    n_batches = data["x"].shape[0] // batch_size
    batches = {k: v[perm].reshape((n_batches, batch_size) + v.shape[1:])
               for k, v in data.items()}
    losses, maes = [], []
    for i in range(n_batches):
        opt.zero_grad()
        loss, mae = _loss_and_metrics(
            net, {k: v[i] for k, v in batches.items()}, generator, reg_rate)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        maes.append(mae.detach())
    return torch.stack(losses).mean(), torch.stack(maes).mean()


def _monitored_key(cfg: TrainConfig) -> int:
    """Which validation metric early stopping and the plateau schedule
    watch: 0 the loss, 1 the MAE."""
    key = {"val_loss": 0, "val_mae": 1}.get(cfg.monitor_metric)
    if key is None:
        raise ValueError(
            f"monitor_metric must be 'val_loss' or 'val_mae', "
            f"got {cfg.monitor_metric!r}")
    return key


@torch.no_grad()
def _select_(mask: torch.Tensor, dst: list[torch.Tensor],
             src: list[torch.Tensor]) -> None:
    """dst = src where mask, in place."""
    for d, s in zip(dst, src):
        d.copy_(torch.where(mask, s, d))


class _Run:
    """The trainer's state on the device: the module, its optimizer, the
    data, and the early-stopping bookkeeping as tensors."""

    # columns of an epoch's record
    RECORD = ("train_loss", "train_mae", "val_loss", "val_mae", "nan", "lr",
              "active")

    def __init__(self, cfg, spec, params, data, val_data, batch_size,
                 device):
        self.cfg, self.spec, self.device = cfg, spec, device
        self.net = head_net(spec, device=device)
        self.net.load_state_dict(params_from_jax(spec, params))
        self.names = [n for n, _ in self.net.named_parameters()]
        self.params = [p for _, p in self.net.named_parameters()]
        self.opt = make_optimizer(cfg, self.params)
        self.data, self.val_data, self.batch_size = data, val_data, batch_size
        self.monitor = _monitored_key(cfg)

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype, device=device)

        self.best_val = scalar(float("inf"), torch.float32)
        self.best_epoch = scalar(-1, torch.int64)
        self.wait = scalar(0, torch.int64)
        self.stop = scalar(False, torch.bool)
        self.nan_recoveries = scalar(0, torch.int64)
        self.best_params = [p.detach().clone() for p in self.params]

    def tree(self, tensors: list[torch.Tensor]) -> Any:
        """Parameters in the module's order → params in JAX layout."""
        return params_to_jax(self.spec, dict(zip(self.names, tensors)))

    def load_params(self, dst: list[torch.Tensor], tree: Any) -> None:
        sd = params_from_jax(self.spec, tree)
        with torch.no_grad():
            for name, t in zip(self.names, dst):
                t.copy_(sd[name])

    def epoch(self, epoch: int, snapshot: bool) -> torch.Tensor:
        """Train and validate one epoch and update the bookkeeping, all on
        the device; returns the epoch's record (RECORD's columns).  An epoch
        after the run has stopped (`snapshot`: possible inside a block)
        leaves params, optimizer and bookkeeping as they were."""
        cfg = self.cfg
        active = ~self.stop
        if snapshot:
            saved_params = [p.detach().clone() for p in self.params]
            saved_opt = [t.clone() for t in self.opt.state_tensors()]
        generator = torch.Generator(device=self.device).manual_seed(
            _epoch_seed(cfg.seed, epoch, 1))
        train_loss, train_mae = _train_epoch(
            self.net, self.opt, self.data,
            _permutation(cfg.seed, epoch, self.data["x"].shape[0],
                         self.device),
            generator, self.batch_size, cfg.regularizer_rate)
        with torch.no_grad():
            val_loss, val_mae = _loss_and_metrics(
                self.net, self.val_data, None, cfg.regularizer_rate)
            finite = torch.isfinite(train_loss) & torch.isfinite(val_loss)
            ok, nan = active & finite, active & ~finite
            monitored = (val_loss, val_mae)[self.monitor]
            improved = ok & (monitored
                             < self.best_val - cfg.early_stopping_min_delta)
            self.best_val = torch.where(improved, monitored, self.best_val)
            self.best_epoch = torch.where(
                improved, torch.full_like(self.best_epoch, epoch),
                self.best_epoch)
            _select_(improved, self.best_params, self.params)
            self.wait = torch.where(
                ok, torch.where(improved, 0, self.wait + 1), self.wait)
            recoveries = self.nan_recoveries + nan.long()
            self.stop = (self.stop
                         | (ok & (self.wait >= cfg.early_stopping_patience))
                         | (nan & (recoveries > 3)))
            self.nan_recoveries = recoveries
            if snapshot:       # a stopped run's trailing epoch: undo it
                _select_(~active, self.params, saved_params)
                _select_(~active, self.opt.state_tensors(), saved_opt)
            # NaN: back to the best weights with a fresh optimizer that
            # keeps the (possibly reduced) learning rate
            _select_(nan, self.params, self.best_params)
            fresh = self.opt.state_tensors()[1:]
            _select_(nan, fresh, [torch.zeros_like(t) for t in fresh])
            if cfg.reduce_lr_on_plateau:
                lr = self.opt.lr
                reduce = (ok & ~improved & (self.wait > 0)
                          & (self.wait % cfg.reduce_lr_patience == 0)
                          & ~self.stop)
                lr.copy_(torch.where(
                    reduce, torch.clamp(lr * cfg.reduce_lr_factor,
                                        min=cfg.min_lr), lr))
            return torch.stack([train_loss, train_mae, val_loss, val_mae,
                                nan.float(), self.opt.lr.clone(),
                                active.float()])

    def read(self, records: list[torch.Tensor]):
        """The block's records and the bookkeeping, in one device→host
        copy."""
        book = torch.stack([self.best_val.double(), self.best_epoch.double(),
                            self.wait.double(), self.stop.double()])
        host = torch.cat([torch.stack(records).double().reshape(-1),
                          book]).cpu().numpy()
        recs = host[:-4].reshape(len(records), len(self.RECORD))
        best_val, best_epoch, wait, stop = host[-4:]
        return (recs, float(np.float32(best_val)), int(best_epoch),
                int(wait), bool(stop))


@dataclasses.dataclass
class TrainResult:
    spec: Any
    params: Any            # best (restored) parameters, JAX layout
    history: list[dict[str, float]]
    best_epoch: int
    best_val_loss: float
    test_metrics: dict[str, dict[str, float]]
    run_dir: str | None = None


def evaluate(spec, params, ds: Dataset,
             device: str | torch.device | None = None) -> dict[str, float]:
    """Unweighted loss (MSE) and MAE of a head on a dataset, in fp32 with
    TF32 off.  Sample weights are ignored: test metrics stay comparable
    across weighted and unweighted runs and match the reference evaluator
    (Model-96/test.py:41-54)."""
    device = resolve_device(device)
    net = head_net(spec, device=device).eval()
    net.load_state_dict(params_from_jax(spec, params))
    data = _pad_dataset(Dataset(ds.features, ds.poses), 1, device)
    with fp32_exact(), torch.no_grad():
        loss, mae = _loss_and_metrics(net, data, None, 0.0)
    return {"loss": float(loss), "mae": float(mae)}


def fit(cfg: TrainConfig, train_ds: Dataset, val_ds: Dataset | None = None,
        test_sets: dict[str, Dataset] | None = None,
        logger: MetricLogger | None = None, spec=None, params=None,
        mesh=None, resume: bool = False, progress_every: int = 0,
        device: str | torch.device | None = None) -> TrainResult:
    """Train a pose head (the reference's train() flow, train_96.py:113-209:
    split → callbacks → fit → test evaluations → summary).

    `spec`/`params` override the config's head and its fresh init (params
    in JAX layout, e.g. handed over from a JAX process); without params the
    head is initialised from `torch.Generator().manual_seed(cfg.seed)`.
    Returns the best (restored) params in JAX layout."""
    from ..data.datasets import difficulty_weights, train_val_split

    if mesh is not None:
        raise NotImplementedError(
            "multi-device training (fit(mesh=...)) is not ported yet: "
            "ROADMAP §1 item 8 (torch.distributed)")
    _monitored_key(cfg)                       # fail fast on a bad metric
    device = resolve_device(device)
    if resume and cfg.run_name is None:
        # a fresh random run id can never name an existing checkpoint
        raise ValueError(
            "fit(resume=True) needs cfg.run_name to locate the prior "
            "run's checkpoints (a fresh run gets a random id)")
    if cfg.use_sample_weights and train_ds.weights is None:
        train_ds = Dataset(train_ds.features, train_ds.poses,
                           difficulty_weights(train_ds.poses))
    if val_ds is None:
        train_ds, val_ds = train_val_split(train_ds, cfg.val_fraction,
                                           cfg.split_seed)
    if spec is None:
        spec = build_head(cfg)
    if params is None:
        params = spec.init(torch.Generator().manual_seed(cfg.seed))

    batch_size = min(cfg.batch_size, len(train_ds))
    run = _Run(cfg, spec, params, _pad_dataset(train_ds, batch_size, device),
               _pad_dataset(val_ds, 1, device), batch_size, device)

    run_id = cfg.run_name or new_run_id()
    ckpt_dir = os.path.join(cfg.checkpoint_dir, run_id)
    start_epoch, best_val, best_epoch, wait = 0, float("inf"), -1, 0
    if resume:
        restored = restore_checkpoint(ckpt_dir)
        if restored is not None:
            # written after epoch `step` completed: continue at step + 1
            step, ckpt_params, opt_state, meta, ckpt_best = restored
            start_epoch = step + 1
            best_val = meta.get("best_val", best_val)
            best_epoch = meta.get("best_epoch", best_epoch)
            wait = meta.get("wait", 0)
            run.load_params(run.params, ckpt_params)
            run.opt.load_state_tree(opt_state)
            run.load_params(run.best_params, ckpt_best if ckpt_best
                            is not None else ckpt_params)
            run.best_val.fill_(best_val)
            run.best_epoch.fill_(best_epoch)
            run.wait.fill_(wait)

    history: list[dict[str, float]] = []
    t0 = time.time()
    epoch = start_epoch - 1
    k = max(1, int(cfg.epochs_per_sync))
    prev_lr = float(np.float32(cfg.learning_rate))
    prev_best_epoch = best_epoch
    nan_recoveries = 0
    with fp32_exact():
        for block_start in range(start_epoch, cfg.total_epochs, k):
            epochs = range(block_start, min(block_start + k,
                                            cfg.total_epochs))
            records = [run.epoch(e, snapshot=k > 1) for e in epochs]
            recs, best_val, best_epoch, wait, stop = run.read(records)
            for e, rec in zip(epochs, recs):
                rec = dict(zip(_Run.RECORD, rec))
                if not rec["active"]:
                    continue
                epoch = e                      # last epoch actually run
                if rec["nan"]:
                    nan_recoveries += 1
                    if logger is not None:
                        logger.log({"epoch": epoch,
                                    "nan_recovery": nan_recoveries},
                                   step=epoch)
                    continue
                row = {"epoch": epoch}
                row.update({key: float(np.float32(rec[key])) for key in
                            ("train_loss", "train_mae", "val_loss",
                             "val_mae")})
                history.append(row)
                if logger is not None:
                    logger.log(row, step=epoch)
                if progress_every and epoch % progress_every == 0:
                    print(f"[{run_id}] epoch {epoch} "
                          f"loss {row['train_loss']:.4f} "
                          f"val {row['val_loss']:.4f} "
                          f"({time.time() - t0:.1f}s)")
                lr_i = float(np.float32(rec["lr"]))
                if cfg.reduce_lr_on_plateau and lr_i != prev_lr:
                    if logger is not None:
                        logger.log({"epoch": epoch, "learning_rate": lr_i},
                                   step=epoch)
                    prev_lr = lr_i
            if best_epoch > prev_best_epoch:
                # the live params/opt pair at the sync epoch, so a resume
                # replays the remaining epochs exactly, and the best weights
                save_checkpoint(ckpt_dir, epoch, run.tree(run.params),
                                run.opt.state_tree(),
                                best_params=run.tree(run.best_params),
                                extra={"best_val": best_val,
                                       "best_epoch": best_epoch,
                                       "wait": wait, "run_id": run_id})
                prev_best_epoch = best_epoch
            if stop:
                break

    final_params = run.tree(run.best_params if cfg.restore_best_weights
                            else run.params)
    save_pytree(os.path.join(ckpt_dir, "best"), final_params)

    test_metrics = {name: evaluate(spec, final_params, ds, device)
                    for name, ds in (test_sets or {}).items()}
    if logger is not None:
        summary = {"best_epoch": best_epoch + 1, "best_val_loss": best_val,
                   "total_parameters": sum(p.numel() for p in run.params),
                   "epochs_run": epoch + 1}
        for name, m in test_metrics.items():
            summary[f"test_{name}_loss"] = m["loss"]
            summary[f"test_{name}_mae"] = m["mae"]
        logger.summary(summary)
        logger.finish()   # close backends that hold a run open (wandb)

    return TrainResult(spec=spec, params=final_params, history=history,
                       best_epoch=best_epoch, best_val_loss=best_val,
                       test_metrics=test_metrics, run_dir=ckpt_dir)
