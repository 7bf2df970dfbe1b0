"""ptam_cg_tpu: a monocular SLAM engine in JAX with PTAM's capabilities.

The reference implementation (cggos/ptam_cg, C++/TooN/libCVD) defines the
capability surface; this package re-architects it as static-shape
accelerator programs:

- static-shape, masked, SoA data model (`ptam_cg_tpu.models.map_state`)
- dense, batched image kernels (`ptam_cg_tpu.ops`)
- jitted per-frame tracking step (`ptam_cg_tpu.models.tracker`)
- dense Schur-complement bundle adjustment (`ptam_cg_tpu.models.bundle`)
- sharded global BA over a device mesh (`ptam_cg_tpu.parallel`)

The package name is the project's name; the engine runs on NVIDIA GPUs
and on the CPU.
"""

__version__ = "0.1.0"
