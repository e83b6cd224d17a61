"""The native C++ clip loader (``DATA.BACKEND`` 'auto' and 'native')."""

from .loader import NativeClipLoader, build_error, frame_paths_for, native_available

__all__ = ["NativeClipLoader", "build_error", "frame_paths_for", "native_available"]
