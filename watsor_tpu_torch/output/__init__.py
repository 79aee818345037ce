# Copy of watsor_tpu/output/__init__.py; only its imports differ.
from watsor_tpu_torch.output.effects import (DrawEffect, DrawEffectWithContours,
                                             BlendEffect, CopyHeaderEffect,
                                             CopyImageEffect)
from watsor_tpu_torch.output.visual import VisualEffects
from watsor_tpu_torch.output.snapshot import Snapshot

__all__ = ["DrawEffect", "DrawEffectWithContours", "BlendEffect",
           "CopyHeaderEffect", "CopyImageEffect", "VisualEffects", "Snapshot"]
