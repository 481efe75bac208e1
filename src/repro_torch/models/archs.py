"""Config -> model dispatch."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig, remat: str = "full",
                device="cuda") -> TransformerLM:
    """The model of ``cfg``, its parameters allocated on ``device`` and
    not yet initialised (``model.init``); ``remat`` is the block
    recompute policy of ``model.loss`` ("none", "dots", "full")."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (models/recurrent.py, "
            "models/ssm.py) is not ported yet (ROADMAP 'Still to port': "
            "SSM/recurrent)")
    return TransformerLM(cfg, remat=remat, device=device)
