"""Checkpoints as one ``torch.save`` file (parity: the JAX package's
utils/checkpoint.py:51,70, in the reference's schema ``{epoch,
state_dict, optimizer, step, best_pred, extra}``, reference
utils/saver.py:54-66). The JAX package's msgpack and orbax backends are
not ported."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer], epoch: int,
                    best_pred: float, step: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    torch.save({"epoch": epoch,
                "state_dict": model.state_dict(),
                "optimizer": optimizer.state_dict() if optimizer is not None else None,
                "step": int(step),
                "best_pred": float(best_pred),
                "extra": extra or {}}, path)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    device=None) -> Dict[str, Any]:
    """Restore ``model`` (strict) and, when given, ``optimizer`` from
    ``path``, read with ``map_location=device`` (the model's device when
    omitted); returns the payload."""
    if device is None:
        device = next(model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(payload["state_dict"])
    if optimizer is not None and payload["optimizer"] is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return payload
