"""Step factories: the steps of ``repro/runtime/steps.py``.

``make_train_step`` takes the loss's gradient with ``torch.autograd.grad``
over copies of the parameter leaves marked ``requires_grad`` (the
parameters themselves stay plain tensors, as JAX's arrays are) and applies
AdamW; ``make_eval_step`` returns the loss's metrics. ``make_prefill_step``
and ``make_decode_step`` wrap a model's ``prefill`` and ``decode`` (the
one-shot slot-cache path; a scalar ``cache["pos"]`` decodes the whole batch
at one position). The port runs eagerly, so a step is the plain function
JAX would ``jit``. On the card the loss's forward runs the kernels, and
their gradients come through ``kernels.ops.KernelGrad``. On a mesh:
``make_sharded_train_step`` (data and tensor parallel, the trainer's) and
``make_compressed_train_step`` (JAX's DP step with the int8
error-feedback all-reduce).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.optim import adamw
from repro_torch.tree import flatten, unflatten


def loss_and_grads(model, params, batch, *, remat: bool = False):
    """(loss, aux, grads): the loss on ``batch`` and its gradient with
    respect to every parameter leaf (``grads`` in the params' structure
    and dtypes). ``aux`` is detached."""
    marked = {k: v.detach().requires_grad_(True)
              for k, v in flatten(params).items()}
    loss, aux = model.loss(unflatten(params, marked), batch, remat=remat)
    grads = torch.autograd.grad(loss, list(marked.values()))
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            unflatten(params, dict(zip(marked, grads))))


def accumulated_grads(model, params, batch, *, remat: bool = True,
                      microbatches: int = 1):
    """(loss, aux, grads) of the loss on ``batch``; ``microbatches > 1``
    cuts the batch into m slices along its rows, accumulates their
    gradients in f32 (activation memory scales 1/m) and averages them, the
    loss and metrics too, as JAX's scan does."""
    m = int(microbatches)
    if m <= 1:
        return loss_and_grads(model, params, batch, remat=remat)
    gsum, auxes, losses = {}, [], []
    for i in range(m):
        one = {k: v.reshape(m, v.shape[0] // m, *v.shape[1:])[i]
               for k, v in batch.items()}
        loss, aux, g = loss_and_grads(model, params, one, remat=remat)
        for k, x in flatten(g).items():
            gsum[k] = x.float() + gsum.get(k, 0.0)
        auxes.append(aux)
        losses.append(loss)
    grads = unflatten(params, {k: g / m for k, g in gsum.items()})
    aux = {k: torch.mean(torch.stack([a[k] for a in auxes]))
           for k in auxes[0]}
    return torch.mean(torch.stack(losses)), aux, grads


def make_train_step(model, opt_cfg: adamw.AdamWConfig, *,
                    remat: bool = True, microbatches: int = 1) -> Callable:
    """(params, opt_state, batch) → (params', opt_state', metrics).

    ``microbatches > 1`` accumulates the gradients of batch slices in f32
    (:func:`accumulated_grads`), then takes one AdamW step; the metrics are
    the mean over the slices, as in JAX."""

    def train_step(params, opt_state, batch):
        _, aux, grads = accumulated_grads(model, params, batch, remat=remat,
                                          microbatches=microbatches)
        params, opt_state, om = adamw.apply(opt_cfg, params, grads,
                                            opt_state)
        return params, opt_state, {**aux, **om}

    return train_step


def _dp(mesh):
    """(group, size, coordinate) of the mesh's data-parallel axes."""
    dp = mesh.dp_axes
    return mesh.group(dp), mesh.axis_size(dp), mesh.coord(dp)


def shard_batch(batch, n: int, i: int):
    """Rows [i·B/n, (i+1)·B/n) of every batch leaf, as
    ``parallel.sharding.batch_pspecs`` cuts the batch axis; a batch that
    ``n`` does not divide stays whole on every rank (the rules replicate
    it)."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0] if v.ndim else 0
        out[k] = (v[i * (B // n):(i + 1) * (B // n)]
                  if n > 1 and B >= n and B % n == 0 else v)
    return out


def token_count(batch) -> torch.Tensor:
    """The positions the LM loss averages over (f32 scalar): the labels'
    next-token positions, restricted by ``loss_mask`` where one is given."""
    labels = batch["labels"]
    if "loss_mask" in batch:
        return batch["loss_mask"][:, 1:].float().sum()
    return torch.tensor(float(labels.shape[0] * (labels.shape[1] - 1)),
                        device=labels.device)


def make_sharded_train_step(model, opt_cfg: adamw.AdamWConfig, mesh, *,
                            specs, remat: bool = True,
                            microbatches: int = 1,
                            fsdp: bool = False) -> Callable:
    """The train step on a mesh (explicit SPMD): (params, opt_state, batch)
    → (params', opt_state', metrics), ``params`` this rank's blocks under
    ``specs`` (``parallel.sharding.param_pspecs``), ``batch`` the whole
    batch (every rank the same).

    The batch is cut over the data axes and the model runs under the mesh
    policy (its model axis: tensor parallelism, ``parallel.tp``), on
    ``microbatches`` slices of the rank's rows (:func:`accumulated_grads`).
    The DP gradient is each shard's gradient weighted by its token count and
    all-reduced: the gradient of the whole batch's token mean, whatever
    the shards' counts. ``fsdp`` (ZeRO-3: ``specs`` from ``param_pspecs(...,
    fsdp=True)``): the leaves cut over "data" are all-gathered for the
    step, and their weighted gradient is reduce-scattered over "data" (over
    "pod" it is all-reduced first), so each rank keeps, and updates, its
    block. The clip norm sums every leaf once: a leaf cut over "model"
    and/or "data" contributes the sum over those groups. On a mesh of one
    rank this is the meshless step, bit for bit."""
    import torch.distributed as dist

    from repro_torch.parallel import activation as act
    from repro_torch.parallel.sharding import spec_at
    from repro_torch.parallel.tp import gather_fsdp
    group, D, d = _dp(mesh)
    nmdl = mesh.axis_size("model")
    zero = bool(fsdp) and mesh.axis_size("data") > 1
    npod = mesh.axis_size("pod") if "pod" in mesh.shape else 1

    def cut(key: str) -> Tuple[str, ...]:
        """The axes of size > 1 that cut a leaf, of "data" and "model"."""
        spec = tuple(spec_at(specs, key))
        return tuple(a for a in ("data", "model")
                     if a in spec and mesh.axis_size(a) > 1
                     and (a == "model" or zero))

    def reduce_block(g, key: str):
        """A ZeRO-3 leaf's summed gradient: this rank's block of it."""
        dim = tuple(spec_at(specs, key)).index("data")
        if npod > 1:
            dist.all_reduce(g, group=mesh.group("pod"))
        parts = [p.contiguous() for p in g.chunk(mesh.axis_size("data"),
                                                  dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=mesh.group("data"))
        return out

    def train_step(params, opt_state, batch):
        local = shard_batch(batch, D, d)
        full = gather_fsdp(params, specs, mesh) if zero else params
        with act.use(mesh, fsdp=fsdp):
            loss, aux, grads = accumulated_grads(
                model, full, local, remat=remat, microbatches=microbatches)
        del full        # the gathered weights are freed before the update
        if D > 1:
            n = token_count(local)
            tot = n.clone()
            dist.all_reduce(tot, group=group)
            flat = flatten(grads)
            for k, g in flat.items():
                g = g.float() * n
                if "data" in cut(k):
                    g = reduce_block(g, k)
                else:
                    dist.all_reduce(g, group=group)
                flat[k] = g / tot
            grads = unflatten(params, flat)
            loss = loss * n
            dist.all_reduce(loss, group=group)
            loss = loss / tot
            aux = {"loss": loss, "ppl": torch.exp(loss)}
        gnorm = None
        if nmdl > 1 or zero:
            sq = {}
            for k, g in flatten(grads).items():
                axes = cut(k)
                sq[axes] = sq.get(axes, 0.0) + torch.sum(
                    torch.square(g.to(torch.float32)))
            total = torch.zeros((), device=loss.device)
            for axes, s in sq.items():
                s = s.clone()
                for a in axes:
                    dist.all_reduce(s, group=mesh.group(a))
                total = total + s
            gnorm = torch.sqrt(total)
        params, opt_state, om = adamw.apply(opt_cfg, params, grads,
                                            opt_state, grad_norm=gnorm)
        return params, opt_state, {**aux, **om}

    return train_step


def make_compressed_train_step(model, opt_cfg: adamw.AdamWConfig, mesh, *,
                               remat: bool = True) -> Callable:
    """Train step with the int8 error-feedback DP all-reduce
    (``parallel.compression``): the twin of JAX's, whose model runs
    replicated per DP shard (TP is not composed here: this variant is for
    parameter-light models, where the DP gradient all-reduce dominates).
    The parameters are whole on every rank, and the batch is cut over the
    data axes by ``batch_pspecs``' rule (:func:`shard_batch`). JAX's
    ``pspecs`` and ``batch_pspecs_tree`` arguments are left out: its step
    reads the first nowhere, and the second states that rule.

    (params, opt_state, residuals, batch) → (params', opt', residuals',
    metrics), the metrics averaged over the data axes."""
    import torch.distributed as dist

    from repro_torch.parallel import compression
    group, D, d = _dp(mesh)

    def step(params, opt_state, residuals, batch):
        local = shard_batch(batch, D, d)
        _, aux, grads = loss_and_grads(model, params, local, remat=remat)
        grads, residuals = compression.compress_allreduce(grads, residuals,
                                                          group)
        params, opt_state, om = adamw.apply(opt_cfg, params, grads,
                                            opt_state)
        metrics = {}
        for k, v in {**aux, **om}.items():
            v = torch.as_tensor(v, dtype=torch.float32,
                                device=_device(grads)).clone()
            dist.all_reduce(v, group=group)
            metrics[k] = v / D
        return params, opt_state, residuals, metrics

    return step


def _device(tree):
    return next(iter(flatten(tree).values())).device


def make_eval_step(model) -> Callable:
    """(params, batch, gate_vals=None) → the loss's metrics (``loss``,
    ``ppl``), without a graph."""
    def eval_step(params, batch, gate_vals=None):
        with torch.no_grad():
            _, aux = model.loss(params, batch, gates=gate_vals)
        return aux
    return eval_step


def make_prefill_step(model, max_len: int, *, kv_dtype=None,
                      gates: bool = False) -> Callable:
    """(params, batch[, gates]) → (last_logits, cache)."""
    if gates:
        def prefill_step(params, batch, gate_vals):
            return model.prefill(params, batch, max_len, gates=gate_vals,
                                 kv_dtype=kv_dtype)
    else:
        def prefill_step(params, batch):
            return model.prefill(params, batch, max_len, kv_dtype=kv_dtype)
    return prefill_step


def make_decode_step(model, *, gates: bool = False) -> Callable:
    """(params, cache, tokens[, gates]) → (logits, cache)."""
    if gates:
        def decode_step(params, cache, tokens, gate_vals):
            return model.decode(params, cache, tokens, gates=gate_vals)
    else:
        def decode_step(params, cache, tokens):
            return model.decode(params, cache, tokens)
    return decode_step
