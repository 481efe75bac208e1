"""Train and eval step builders, the counterpart of ``repro.train.steps``.

A train state is ``{"params", "opt": {"m", "v", "step"}}`` with every
tree keyed by the model's parameter names (``blocks.3.attn.wq``); its
``params`` are the model's own parameters, which ``model.loss`` reads
and the step updates in place.  ``models.transformer.
train_state_to_reference`` / ``train_state_from_reference`` move it to
and from the reference's layout (``blocks`` stacked on L, zamba's
``mamba`` on (G, K)), the layout train checkpoints keep.

FSDP execution: ``shard_train_state(model, state, rules)`` cuts every
parameter and moment to this rank's block of the reference's spec,
fitted (``sharding.fit_spec``); ``make_train_step``'s step, called under
``sharding.use_rules(rules)`` with the rank's block of the batch
(``models.inputs.shard_batch``), gathers each block's weights at use,
reduce-scatters the gradients back to the blocks and updates them
there; its metrics are the reference's, equal on every rank.  A spec
may cut a parameter on a ``tp`` dimension as well (``megatron_sp``,
``tp_dp``): that slice is never gathered, the layers run on it
(``models.transformer``, ``models.recurrent``).
``shard_params`` cuts the parameters alone, for serving (``tp_sp``).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models.transformer import reference_path
from repro_torch.train.optimizer import (
    OptConfig,
    abstract_opt_state,
    adamw_update,
    init_opt_state,
    opt_state_specs,
)


def reference_decay(params: dict) -> dict[str, bool]:
    """Where the reference's AdamW decays: at ``p.ndim >= 2`` in its
    tree, where a stacked leaf carries its stacked axes
    (``transformer.reference_path``).  So every leaf of ``blocks`` (L)
    and of zamba's ``mamba`` (G, K) decays, norm scales and the (H,)
    SSM leaves included; of the unstacked leaves (the embedding, final
    norm, rwkv's ``ln_in``, zamba's ``shared`` block, the moe family's
    ``pre_blocks``) only the matrices do."""
    return {n: p.ndim + len(reference_path(n)[1]) >= 2
            for n, p in params.items()}


def make_train_step(model, opt_cfg: OptConfig, *, microbatches: int = 1,
                    on_microbatch=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the
    state is updated in place and returned.

    Gradients come from ``torch.autograd.grad`` of ``model.loss``.
    ``microbatches > 1`` runs gradient accumulation: the global batch is
    split on dim 0 and run sequentially, each micro-batch's gradients
    added into float32 accumulators (as the reference's scan does), so
    live activations shrink by the factor while the math stays the
    reference's.  Metrics are 0-d tensors: ``loss``, ``nll``,
    ``accuracy``, ``tokens``, ``aux_loss``, ``grad_norm`` and ``step``.
    On a sharded state (``shard_train_state``) under active rules the
    accumulators are the blocks' shapes, and ``loss`` is the reference's
    (the model's metrics carry it: its objective is the rank's share).
    ``on_microbatch(i)``, if given, is called after micro-batch ``i``'s
    gradients, loss and metrics are added in (the dry run counts one
    micro-batch's work from it).
    """

    def grad_fn(params: dict, batch: dict):
        loss, metrics = model.loss(batch)
        # a parameter the batch does not reach (the audio family's token
        # embedding) has a zero gradient, as ``jax.grad`` gives it
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
            torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True), params.values())]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics.pop("loss", loss.detach()), metrics, dict(
            zip(params, grads))

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if microbatches == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            mb = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                               *x.shape[1:]) for k, x in batch.items()}
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            loss, metrics = None, None
            for i in range(microbatches):
                l_i, m_i, g_i = grad_fn(params,
                                        {k: x[i] for k, x in mb.items()})
                for n, g in g_i.items():
                    grads[n].add_(g.float())
                del g_i
                loss = l_i if loss is None else loss + l_i
                metrics = m_i if metrics is None else {
                    k: metrics[k] + m_i[k] for k in metrics}
                if on_microbatch is not None:
                    on_microbatch(i)
            k = float(microbatches)
            grads = {n: g / k for n, g in grads.items()}
            loss = loss / k
            metrics = {n: m / k for n, m in metrics.items()}

        _, opt, gnorm = adamw_update(opt_cfg, grads, params, state["opt"],
                                     decay=reference_decay(params))
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm,
                        "step": opt["step"].clone()})
        return state, metrics

    return train_step


def make_eval_step(model):
    @torch.no_grad()
    def eval_step(batch):
        loss, metrics = model.loss(batch)
        return dict({"loss": loss}, **metrics)
    return eval_step


def param_specs(model) -> dict[str, tuple]:
    """Each parameter's logical spec, by name: its reference leaf's spec
    (``model.SPECS``) without the stacked axes."""
    return {n: model.SPECS[reference_path(n)[0][-2:]]
            for n, _ in model.named_parameters()}


@torch.no_grad()
def shard_params(model, rules: shd.MeshRules) -> dict:
    """Each parameter of ``model`` cut in place to this rank's block of
    its fitted spec under ``rules`` (it keeps its object, holding its
    block, marked with its logical spec and whole shape: ``sharding.
    mark_sharded``); returns ``{name: sharding}``, each block's
    ``Sharding``.  A spec that cannot be realised raises
    (``sharding.param_layout``).  Every rank calls it together: it makes
    the process groups the model will use."""
    specs = param_specs(model)
    params = dict(model.named_parameters())
    layouts = {name: shd.param_layout(rules, specs[name], p.shape)
               for name, p in params.items()}    # every refusal first
    cuts = {}
    for name, p in params.items():
        for axes in (layouts[name].axes, layouts[name].rest):
            if axes:
                shd.axes_group(rules.mesh, axes)
        cuts[name] = rules.named(shd.fitted(rules, specs[name], p.shape))
        shd.mark_sharded(p, specs[name], p.shape)
        p.data = shd.local_shard(p.data, cuts[name]).clone()
        shd.norm_group(p, rules)
    shd.objective_group(rules)
    return cuts


@torch.no_grad()
def shard_train_state(model, state: dict, rules: shd.MeshRules) -> dict:
    """FSDP: ``state``'s parameters (the model's own) and moments cut to
    this rank's blocks of their fitted specs under ``rules``, in place
    (``shard_params``); the whole tensors are freed."""
    opt = state["opt"]
    for name, sharding in shard_params(model, rules).items():
        for moments in (opt["m"], opt["v"]):
            moments[name] = shd.local_shard(moments[name], sharding).clone()
    return state


def init_train_state(model, generator: torch.Generator,
                     opt_dtype=torch.float32) -> dict:
    """Seeded weights (``model.init``) and zero moments: the state holds
    the model's own parameters."""
    model.init(generator)
    params = dict(model.named_parameters())
    return {"params": params, "opt": init_opt_state(params, opt_dtype)}


def abstract_train_state(model, opt_dtype=torch.float32):
    """(state as meta tensors, state specs), in the reference's layout
    (``model.abstract()``) — what a train checkpoint holds; no
    allocation."""
    shapes, specs = model.abstract()
    return ({"params": shapes, "opt": abstract_opt_state(shapes, opt_dtype)},
            {"params": specs, "opt": opt_state_specs(specs)})


def metric_specs(metrics_tree: Any):
    """Every metric replicated."""
    return {k: () for k in metrics_tree}
