"""Config -> model dispatch."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.recurrent import RWKVModel, ZambaModel
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig, remat: str = "full", device="cuda"):
    """The model of ``cfg``, its parameters allocated on ``device`` and
    not yet initialised (``model.init``); ``remat`` is the block
    recompute policy of ``model.loss`` ("none", "dots", "full")."""
    if cfg.family == "ssm":
        return RWKVModel(cfg, remat=remat, device=device)
    if cfg.family == "hybrid":
        return ZambaModel(cfg, remat=remat, device=device)
    return TransformerLM(cfg, remat=remat, device=device)
