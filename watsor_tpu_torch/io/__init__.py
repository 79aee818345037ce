# Copy of watsor_tpu/io/__init__.py; only its imports differ.
from watsor_tpu_torch.io.native import available as native_available, NativeUnavailable

__all__ = ["native_available", "NativeUnavailable"]
