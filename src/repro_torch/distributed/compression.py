"""Int8 gradient compression with error feedback over the pod axis.

The counterpart of ``repro.distributed.compression``.  The pod-to-pod
hop is the slowest link of a (pod, data, model) mesh; the gradients
cross it quantized, while an error-feedback buffer keeps what each
pod's quantization lost and adds it back at the next step.

The codec is per-tensor symmetric int8, the reference's arithmetic op
for op as XLA compiles it (its train step and grad sync always run
compiled): s = max|g| / 127, which XLA folds into a multiply by
float32(1/127), floored at 1e-12; q = clip(round(g / s), ±127) with a
true division and ``torch.round`` (half to even, as ``jnp.round``); the
residual ``x - q * s`` rounded once, as XLA's fused multiply-add gives
it.  So ``q``, ``s`` and the new error come out bit-equal to the
compiled reference's for the same input.

The pod hop runs under torch SPMD: each rank holds its local block and
calls ``all_reduce`` on the pod group (``mesh.get_group("pod")``)
through ``torch.distributed``, whatever its backend.  As in the
reference, ``q`` is widened to int32 before its sum (exact for up to
2**24 pods), so the hop carries 4 bytes an element plus one float32
scale a tensor, and the sum is decoded with the mean scale:
``tot * (s_tot / n) / n``.

The compressed train step takes a replicated state or an FSDP one
(``train.steps.shard_train_state`` under ``fsdp_dp``, the reference's
compressed cells of the ssm and hybrid families, or under
``megatron_sp``, its cells of the attention families on (pod, data,
model), the parameters then cut on their ``tp`` dimension too).  In
the reference the step is manual over "pod" only and GSPMD shards
(data, model) inside each pod, so a pod's gradient leaf is one array:
its scale is the max over the whole pod-local leaf.  The FSDP step therefore runs the model
under rules manual over "pod" on each parameter's pod-local block,
which reduce-scatters the pod-local gradient over the pod's other axes;
each scale's max is all-reduced over them before ``_scale``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.distributed import sharding as shd


# float32(1 / 127), the constant XLA multiplies by for ``/ 127.0``
INV_127 = 0.007874015718698502


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax.to(torch.float32) * INV_127, 1e-12)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / s) clipped to ±127, as float32 values."""
    return torch.clamp(torch.round(x / scale), -127, 127)


def _residual(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``x - q * s`` rounded once, as the compiled reference fuses it.
    Product and difference are exact in float64 (q has 8 bits, s 24,
    and q != 0 only where |x| >= s / 2), so the one rounding is the
    cast back to float32."""
    return (x.double() - q.double() * scale.double()).to(torch.float32)


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale 0-d float32) of ``g``."""
    scale = _scale(torch.max(torch.abs(g)))
    return _quantize(g.to(torch.float32), scale).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compress_residual(g: torch.Tensor, err: torch.Tensor):
    """Error feedback: compress x = g + err; the new err is x less its
    decoded value.  Returns (q, scale, new err)."""
    x = g.to(torch.float32) + err
    q, s = quantize_int8(x)
    return q, s, _residual(x, q, s)


def init_error_state(grads: Any) -> Any:
    """Float32 zeros shaped like each leaf of ``grads``."""
    return pytree.map_with_keys(
        lambda _key, g: torch.zeros(g.shape, dtype=torch.float32,
                                    device=g.device), grads)


# --------------------------------------------------------------------------
# the pod hop
# --------------------------------------------------------------------------


def _pod_group(rules: shd.MeshRules):
    if "pod" not in rules.all_axes:
        raise ValueError(f"the mesh {rules.all_axes} has no 'pod' axis")
    return rules.mesh.get_group("pod"), shd.axes_size(rules.mesh, "pod")


def _pod_leaf(gs: list, errs: list, group, n: int, amax_group=None):
    """The pod hop of one reference leaf, held as the tensors ``gs``
    (with their errors ``errs``) that share its one scale: a layer-
    stacked leaf is one tensor there and one tensor a layer here; the
    arithmetic is elementwise but for the max.  The scales are summed
    first, then each tensor's q as int32 and decoded with the mean scale
    ``tot * (s_tot / n) / n``: the reference's arithmetic, with one
    tensor's sum alive at a time.  Returns (decoded gradients in each
    ``g``'s dtype, new errors, int32 sums, scale sum).  The tensors may
    be this rank's blocks of the leaf, the rest of it on the ranks of
    ``amax_group``, over which the max is then taken."""
    amax = torch.stack([(g.to(torch.float32) + e).abs().max()
                        for g, e in zip(gs, errs)]).max()
    if amax_group is not None:
        shd.all_reduce_(amax, amax_group, dist.ReduceOp.MAX)
    s = _scale(amax)
    s_tot = s.clone()
    dist.all_reduce(s_tot, group=group)
    mean = s_tot / n
    outs, new_errs, sums = [], [], []
    for g, e in zip(gs, errs):
        x = g.to(torch.float32) + e
        q = _quantize(x, s)
        new_errs.append(_residual(x, q, s))
        del x
        tot = q.to(torch.int32)
        del q
        dist.all_reduce(tot, group=group)
        outs.append(((tot.to(torch.float32) * mean) / n).to(g.dtype))
        sums.append(tot)
        del tot
    return outs, new_errs, sums, s_tot


def _pod_allreduce(grads: Any, err_state: Any, rules: shd.MeshRules,
                   keep_sums: bool = False, leaf_of=None, amax_group=None):
    """(gradients, new errors, and, when ``keep_sums``, a tree like
    ``grads`` of each tensor's (int32 sum, scale sum), else None).
    ``leaf_of(key)`` names the reference leaf a tensor belongs to;
    tensors of one leaf share a scale (default: each its own).  With
    ``amax_group`` each tensor is a block of a leaf whose other blocks
    lie on that group's ranks (``_pod_leaf``)."""
    group, n = _pod_group(rules)
    errs = dict(pytree.flatten_with_keys(err_state))
    leaves: dict = {}
    for key, g in pytree.flatten_with_keys(grads):
        leaves.setdefault(key if leaf_of is None else leaf_of(key),
                          []).append((key, g))
    out, sums = {}, {}
    for members in leaves.values():
        keys = [k for k, _ in members]
        g_out, e_new, tots, s_tot = _pod_leaf(
            [g for _, g in members], [errs[k] for k in keys], group, n,
            amax_group)
        for k, go, en, tot in zip(keys, g_out, e_new, tots):
            out[k] = (go, en)
            if keep_sums:
                sums[k] = (tot, s_tot)
        del tots
    new_g = pytree.map_with_keys(lambda key, _: out[key][0], grads)
    new_e = pytree.map_with_keys(lambda key, _: out[key][1], grads)
    if keep_sums:
        return new_g, new_e, pytree.map_with_keys(
            lambda key, _: sums[key], grads)
    return new_g, new_e, None


def compressed_pod_allreduce(grads: Any, err_state: Any,
                             rules: shd.MeshRules) -> tuple[Any, Any]:
    """All-reduce each rank's gradients over the pod group in int8 (as
    int32 sums) with one float32 scale a tensor and error feedback.
    ``err_state`` is shaped like ``grads``.  Returns (gradients, new
    errors).  The mesh must have a "pod" axis."""
    new_g, new_e, _ = _pod_allreduce(grads, err_state, rules)
    return new_g, new_e


def make_compressed_grad_sync(rules: shd.MeshRules, logical_specs):
    """Returns ``sync(grads, err) -> (grads, err)``: the int8 pod hop,
    or the identity when the mesh has no pod axis.  ``logical_specs``
    is the params' logical spec tree; each rank already holds its local
    block, so the specs are only resolved (an unknown axis raises)."""
    if "pod" not in rules.all_axes:
        return lambda g, e: (g, e)
    shd.spec_map(lambda s: rules.spec(*s), logical_specs)

    def sync(grads, err):
        return compressed_pod_allreduce(grads, err, rules)

    return sync


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


def make_compressed_train_step(model, opt_cfg, rules: shd.MeshRules):
    """Returns ``train_step(state, batch, observe=None) -> (state,
    metrics)`` with the pod hop in int8 and error feedback; the state
    (``init_compressed_state``) is updated in place and returned.

    With a replicated state, each rank takes the gradient of its local
    batch's loss (the model runs with no active rules: it sees local,
    replicated weights); with a data axis larger than 1 the gradients
    are averaged in float32 over the data group, the reduction the
    reference keeps in float32 inside a pod; then the pod hop, then
    AdamW as ``train.steps`` applies it.  ``loss`` and the model's
    metrics are averaged over the data and pod groups (``tokens``, a
    count, is summed over data), as the reference's pod-local loss and
    its ``pmean`` over "pod" give them.

    With an FSDP state (``train.steps.shard_train_state``) each
    parameter's block is first re-cut to its pod-local block (its spec
    under rules manual over "pod"); the model runs under those rules,
    each rank's objective its share of the pod's loss, so the gathers'
    backward leaves each rank its block of the pod-local gradient; the
    pod hop runs on those blocks and the errors (the reference's
    ``P("pod", *fsdp_nopod)`` error state), each scale's max all-reduced
    over the pod's other axes; the decoded blocks are re-cut to the
    state's blocks and AdamW updates them under ``rules``.  The
    metrics are the pods' mean.

    Each parameter is quantized with the scale of the reference's leaf
    it lies in (its layers' stack).  ``observe(grads, err, synced,
    sums)``, if given, sees one step's local gradients, errors, synced
    gradients and each tensor's (int32 sum, scale sum) before the
    update.

    A strategy whose ``tp`` lands on a model axis larger than 1
    (``megatron_sp`` on (pod, data, model)) runs the FSDP step on a
    state whose parameters are cut on their ``tp`` dimension too: the
    model's tensor-parallel layers run on the rank's slices inside the
    pod, and a ``tp``-cut leaf's scale is the max over its model slices
    as over its storage blocks.  There a replicated state raises
    ``ValueError`` (cut it with ``shard_train_state``), and a model
    whose split layers this step does not run raises there
    (``LanguageModel.refuse_compressed_model_axis``).  A mesh without a
    pod axis raises ``ValueError``."""
    from repro_torch.models.transformer import reference_path
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.steps import reference_decay

    mesh = rules.mesh
    sizes = shd.mesh_sizes(mesh)
    if "pod" not in sizes:
        raise ValueError(f"the mesh {rules.all_axes} has no 'pod' axis")
    tp_wide = shd.axes_size(mesh, rules.table["tp"]) > 1
    if tp_wide:
        model.refuse_compressed_model_axis(rules)
    n_data, n_pod = sizes.get("data", 1), sizes["pod"]
    data = mesh.get_group("data") if n_data > 1 else None
    pod = mesh.get_group("pod")
    # the reference quantizes each leaf of its tree, blocks stacked on L
    # (zamba's mamba on (G, K)), with one scale: so do a leaf's layers
    names = {f"[{n!r}]": n for n, _ in model.named_parameters()}

    def leaf_of(key: str):
        return reference_path(names[key])[0]

    fsdp_step = _fsdp_compressed_step(model, opt_cfg, rules, leaf_of)

    def train_step(state: dict, batch: dict, observe=None):
        params = state["params"]
        if shd.is_sharded(next(iter(params.values()))):
            return fsdp_step(state, batch, observe)
        if tp_wide:
            raise ValueError(f"strategy {rules.strategy!r} splits the model "
                             "axis: cut the state with shard_train_state")
        with shd.use_rules(None):
            loss, metrics = model.loss(batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        if data is not None:
            for name, g in grads.items():
                acc = g.to(torch.float32)
                dist.all_reduce(acc, group=data)
                grads[name] = (acc / n_data).to(g.dtype)
        err = {name: e[0] for name, e in state["err"].items()}
        synced, new_err, sums = _pod_allreduce(
            grads, err, rules, keep_sums=observe is not None,
            leaf_of=leaf_of)
        if observe is not None:
            observe(grads, err, synced, sums)
        del grads, sums
        _, opt, gnorm = adamw_update(opt_cfg, synced, params, state["opt"],
                                     decay=reference_decay(params))
        del synced
        with torch.no_grad():
            for name, e in err.items():
                e.copy_(new_err[name])

        metrics = dict(metrics, loss=loss)
        names = sorted(metrics)
        vec = torch.stack([metrics[k].detach().to(torch.float32).reshape(())
                           for k in names])
        if data is not None:
            dist.all_reduce(vec, group=data)
            vec = vec / torch.tensor([1.0 if k == "tokens" else n_data
                                      for k in names], device=vec.device)
        dist.all_reduce(vec, group=pod)
        vec = vec / n_pod
        out = {k: vec[i].to(metrics[k].dtype) for i, k in enumerate(names)}
        out.update({"grad_norm": gnorm, "step": opt["step"].clone()})
        return state, out

    return train_step


def _pod_local(rules: shd.MeshRules) -> shd.MeshRules:
    """The rules of a pod's own step: "pod" held manual."""
    return dataclasses.replace(rules, manual_axes=("pod",))


def _fsdp_compressed_step(model, opt_cfg, rules: shd.MeshRules, leaf_of):
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.steps import reference_decay

    inner = _pod_local(rules)
    in_pod = shd.active_axes(inner)
    pod = rules.mesh.get_group("pod")
    n_pod = shd.axes_size(rules.mesh, "pod")

    def recut(t, p, src, dst):
        return shd.reshard(t, p.fsdp_spec, p.fsdp_shape, src, dst)

    def train_step(state: dict, batch: dict, observe=None):
        params = state["params"]
        amax_group = shd.axes_group(rules.mesh, in_pod) if in_pod else None
        blocks = {n: p.data for n, p in params.items()}
        with torch.no_grad():
            pod_blocks = {n: recut(p.data, p, rules, inner)
                          for n, p in params.items()}
        try:
            for n, p in params.items():
                p.data = pod_blocks[n]
            del pod_blocks
            with shd.use_rules(inner):
                loss, metrics = model.loss(batch)
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
        finally:
            for n, p in params.items():
                p.data = blocks[n]
        metrics = {k: v.detach() for k, v in metrics.items()}
        err = {name: e[0] for name, e in state["err"].items()}
        synced, new_err, sums = _pod_allreduce(
            grads, err, rules, keep_sums=observe is not None,
            leaf_of=leaf_of, amax_group=amax_group)
        if observe is not None:
            observe(grads, err, synced, sums)
        del grads, sums
        with torch.no_grad():
            synced = {n: recut(g, params[n], inner, rules)
                      for n, g in synced.items()}
        with shd.use_rules(rules):
            _, opt, gnorm = adamw_update(opt_cfg, synced, params,
                                         state["opt"],
                                         decay=reference_decay(params))
        del synced
        with torch.no_grad():
            for name, e in err.items():
                e.copy_(new_err[name])

        names = sorted(metrics)
        vec = torch.stack([metrics[k].to(torch.float32).reshape(())
                           for k in names])
        shd.all_reduce_(vec, pod)
        vec = vec / n_pod
        out = {k: vec[i].to(metrics[k].dtype) for i, k in enumerate(names)}
        out.update({"grad_norm": gnorm, "step": opt["step"].clone()})
        return state, out

    return train_step


def init_compressed_state(state: dict, rules: shd.MeshRules | None = None
                          ) -> dict:
    """``state`` with ``err``: this rank's (1, *block) float32 block of
    the reference's (n_pods, *shape) ``P("pod", *fsdp_nopod)`` error
    state, zeros, one per parameter: the whole parameter's shape for a
    replicated state, its pod-local block for an FSDP one (whose
    ``rules`` must be given)."""
    def block(p):
        if not shd.is_sharded(p):
            return tuple(p.shape)
        if rules is None:
            raise ValueError("an FSDP state's error blocks need its rules")
        inner = _pod_local(rules)
        return shd.block_shape(
            shd.param_layout(inner, p.fsdp_spec, p.fsdp_shape), rules.mesh)

    err = {name: torch.zeros((1, *block(p)), dtype=torch.float32,
                             device=p.device)
           for name, p in state["params"].items()}
    return dict(state, err=err)


def abstract_compressed_state(state_shapes: dict, state_specs: dict,
                              n_pods: int):
    """(shapes, specs) of the err-augmented state in the reference's
    layout: meta tensors (n_pods, *shape) float32 and specs ``("pod",
    *spec)`` with each logical axis marked ``_nopod`` (the err array
    carries its pod dimension explicitly)."""
    def meta(p):
        return torch.empty((n_pods, *p.shape), dtype=torch.float32,
                           device="meta")

    def depod(entry):
        if isinstance(entry, str) and not entry.endswith("_nopod"):
            return entry + "_nopod"
        return entry

    err_shapes = shd.spec_map(meta, state_shapes["params"])
    err_specs = shd.spec_map(lambda s: ("pod", *[depod(e) for e in s]),
                          state_specs["params"])
    return (dict(state_shapes, err=err_shapes),
            dict(state_specs, err=err_specs))
