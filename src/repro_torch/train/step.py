"""Loss and train-step factories (arch-agnostic via the ModelApi), after the
JAX package's ``repro.train.step``.

The JAX package's ``jax.value_and_grad`` becomes ``torch.autograd.grad``
over the model's parameters (nothing is left in ``.grad``), and its
``jax.checkpoint`` inside the chunked loss ``torch.utils.checkpoint``.
``loss_unroll``, which only steers XLA, has no counterpart.

A model whose parameters are DTensors (placed on a ``DeviceMesh`` by
``launch.shardings.param_shardings``) trains the same way, its batch placed
by ``batch_shardings``, under the ``sharding_policy`` of that mesh (where
plain tensors, such as the optimizer's scalars, count as replicated); the
loss and the metrics come back replicated.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.local import as_dtensor
from repro_torch.models.blocks import seq_op
from repro_torch.models.registry import ModelApi
from repro_torch.sharding import policy
from repro_torch.sharding.policy import placements_on, shard_as
from repro_torch.train import optim as O


def _nll(logits, labels, z_loss: float):
    """Per-position negative log-likelihood (float32) and the mask of
    positions that carry a label (labels < 0 are masked)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    labels_ = torch.clamp(labels, min=0).long()
    if isinstance(logits, DTensor):
        # the label's logit as a masked sum over the vocab, which a mesh
        # may shard (DTensor's gather from a sharded dim needs real data)
        vocab = torch.arange(logits.shape[-1], device=labels_.device)
        ll = torch.where(vocab == labels_[..., None], logits, 0.0).sum(-1)
    else:
        ll = torch.gather(logits, -1, labels_[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    return nll, (labels >= 0).to(torch.float32)


def softmax_xent(logits, labels, z_loss: float = 0.0):
    """Mean cross-entropy in f32. labels: int, -1 = masked."""
    nll, mask = _nll(logits, labels, z_loss)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _logits_layout(mesh, shape, D: int):
    """The unembedding of a [B, c, D] hidden chunk into [B, c, V] logits on
    a mesh: the placements of (the logits, the hidden chunk, the weight,
    their two gradients). The logits come out in ("batch", "act_seq",
    "vocab") as they are used, each rank multiplying its own rows by the
    weight whole along its contraction dim; so no rank computes another's
    logits, and none moves them. The gradients are partial sums over the
    mesh dims the other operand splits."""
    out = placements_on(mesh, shape, "batch", "act_seq", "vocab")
    h = tuple(q if isinstance(q, Shard) and q.dim < 2 else Replicate()
              for q in out)
    w = tuple(Shard(1) if q == Shard(2) else Replicate() for q in out)
    h_grad = tuple(Partial() if q == Shard(2) else p for q, p in zip(out, h))
    w_grad = tuple(Shard(1) if q == Shard(2) else Partial()
                   if isinstance(q, Shard) else Replicate() for q in out)
    return out, h, w, h_grad, w_grad


def _chunk_loss(h_c, w_unembed, y_c, z_loss: float, layout=None):
    if layout is None:
        logits = shard_as((h_c @ w_unembed).float(), "batch", "act_seq",
                          "vocab")
    else:
        out, h, w, h_grad, w_grad = layout
        logits = local_map(lambda a, b: (a @ b).float(),
                           out_placements=list(out), in_placements=(h, w),
                           in_grad_placements=(h_grad, w_grad),
                           device_mesh=h_c.device_mesh,
                           redistribute_inputs=True)(h_c, w_unembed)
    nll, mask = _nll(logits, y_c, z_loss)
    return torch.sum(nll * mask), torch.sum(mask)


def chunked_softmax_xent(hidden, w_unembed, labels, chunk: int = 512,
                         z_loss: float = 0.0):
    """Cross-entropy without materialising [B,S,V]: a loop over sequence
    chunks; each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``), so peak memory is [B,chunk,V]. On a mesh
    the weight is gathered once, as FSDP gathers a weight before its
    matmul, and each rank computes only its own rows' logits
    (:func:`_logits_layout`): with a vocab the model axis does not split
    DTensor (torch 2.11) would gather the batch and compute every rank's
    logits on every rank."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    layout = None
    if isinstance(hidden, DTensor):
        mesh = hidden.device_mesh
        layout = _logits_layout(mesh, (B, chunk, w_unembed.shape[-1]), D)
        w_unembed = as_dtensor(w_unembed, mesh)
        if tuple(w_unembed.placements) != layout[2]:
            w_unembed = w_unembed.redistribute(mesh, layout[2])
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S, chunk):
        args = (hidden[:, c:c + chunk], w_unembed, labels[:, c:c + chunk],
                z_loss, layout)
        if torch.is_grad_enabled():
            s, n = checkpoint(policy.bound(_chunk_loss), *args,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            s, n = _chunk_loss(*args)
        tot = tot + s
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def make_loss_fn(api: ModelApi, aux_weight: float = 0.01,
                 z_loss: float = 0.0):
    """loss_fn(params, batch) -> (loss, metrics {xent, loss[, moe_aux]})."""
    cfg = api.cfg

    def loss_fn(params, batch):
        hidden, aux = api.forward_hidden(params, batch)
        if cfg.family == "vlm":
            # vision-prefix positions carry no token loss (on a mesh each
            # rank slices its own rows)
            hidden = seq_op(lambda h: h[:, cfg.n_vis_tokens:], hidden)
        w = api.unembed(params)
        loss = chunked_softmax_xent(hidden, w, batch["labels"], z_loss=z_loss)
        metrics = {"xent": loss}
        if aux is not None:
            loss = loss + aux_weight * aux
            metrics["moe_aux"] = aux
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def _replicated(t):
    """A DTensor (a loss, a metric) replicated on its mesh; a plain tensor
    as it is."""
    if isinstance(t, DTensor):
        return t.redistribute(placements=[Replicate()] * t.device_mesh.ndim)
    return t


def make_train_step(api: ModelApi, optimizer: O.AdamW,
                    microbatches: int = 1, grad_transform=None,
                    aux_weight: float = 0.01, constrain_grads: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): a new model and a new state, the inputs left as they were.
    ``microbatches`` > 1 accumulates gradients over equal splits of the
    batch (one after another); the metrics are then the last microbatch's
    ``xent`` and ``loss``, as in the JAX package. ``grad_transform(grads)
    -> grads`` (a dict by parameter name) hooks in compression (top-k EF,
    int8). ``constrain_grads`` puts each gradient into its parameter's
    placements (``shard_as`` with the parameter's logical axes): on the
    FSDP axis a reduce-scatter where DTensor would otherwise keep a partial
    sum or a replica; outside a policy it changes nothing."""
    loss_fn = make_loss_fn(api, aux_weight)
    axes = None
    if constrain_grads:
        from repro_torch.launch.shardings import flatten
        axes = flatten(api.param_axes())

    def single(params, batch):
        names, leaves = zip(*params.named_parameters())
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(_replicated(loss), leaves,
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, leaves, grads)}
        if axes is not None:
            grads = {n: shard_as(g, *axes[n]) for n, g in grads.items()}
        return grads, {k: _replicated(v).detach() for k, v in metrics.items()}

    def accumulate(params, batch):
        parts = {k: torch.chunk(v, microbatches) for k, v in batch.items()}
        acc = None
        for i in range(microbatches):
            grads, metrics = single(params, {k: v[i]
                                             for k, v in parts.items()})
            metrics = {k: metrics[k] for k in ("xent", "loss")}
            acc = grads if acc is None else {
                n: acc[n] + g for n, g in grads.items()}
        return {n: g / microbatches for n, g in acc.items()}, metrics

    def train_step(params, opt_state, batch):
        if not getattr(params, "trainable", False):
            raise ValueError("train_step takes a trainable model: "
                             "api.init(generator, trainable=True) or "
                             "params_from_jax(..., trainable=True)")
        if microbatches > 1:
            if any(v.shape[0] % microbatches for v in batch.values()):
                raise ValueError(f"batch does not split into {microbatches} "
                                 "equal microbatches")
            grads, metrics = accumulate(params, batch)
        else:
            grads, metrics = single(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        with torch.no_grad():
            updates, opt_state, gnorm = optimizer.update(grads, opt_state,
                                                         params)
            params = O.apply_updates(params, updates)
        metrics = dict(metrics)
        metrics["grad_norm"] = _replicated(gnorm)
        return params, opt_state, metrics

    return train_step
