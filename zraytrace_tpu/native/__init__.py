"""Native (C++) host-runtime components, reached via ctypes.

The compute path is JAX/XLA on the accelerator; these cover the host-side
runtime the reference implements natively in Zig: BVH building
(bvh.zig:129-179) and OBJ parsing (obj_reader.zig). Each has a pure
numpy/Python fallback, so the package works without a toolchain.
"""

from zraytrace_tpu.native.build import load_library, native_available

__all__ = ["load_library", "native_available"]
