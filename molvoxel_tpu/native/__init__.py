"""Native host-side components (C++, bound via ctypes).

The compute path is JAX/XLA/Pallas on the GPU; these helpers keep the *host*
side of the pipeline (molecule parsing / data feeding) off the Python
interpreter's critical path.  The shared object is built on demand with g++
(``python -m molvoxel_tpu.native.build`` or automatically on first import);
every entry point has a pure-Python fallback so the package works without a
toolchain.
"""

from .fastparse import NATIVE_AVAILABLE, FlatMolecules, parse_sdf_buffer, parse_sdf_file, parse_sdf_flat

__all__ = ["NATIVE_AVAILABLE", "FlatMolecules", "parse_sdf_buffer", "parse_sdf_file", "parse_sdf_flat"]
