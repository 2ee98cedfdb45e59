"""Texture lookup (port of models/texture.py): only scenes without
textures are ported, where every lookup returns the material's flat
colour."""
from __future__ import annotations

import torch


def resolve(scene, tex_id: torch.Tensor, uv: torch.Tensor,
            fallback: torch.Tensor) -> torch.Tensor:
    """Per-ray reflectance: `fallback` when the scene has no textures."""
    if scene.textures.shape[0] == 1 and scene.textures.shape[1] == 1:
        return fallback
    raise NotImplementedError("texture lookups are not ported")
