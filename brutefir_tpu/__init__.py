"""brutefir_tpu — a multi-channel FIR convolution engine for accelerators.

A ground-up rebuild of the capabilities of BruteFIR (the classic C
partitioned-convolution engine) in JAX: the per-block signal path compiles
to a single jitted XLA program (rfft -> mixing matmuls -> partitioned
spectral MAC -> irfft), runtime controls are block-boundary-snapshotted
device arguments, and the fork/pipe/shared-memory pipeline of the reference
becomes overlapped host I/O and asynchronous device dispatch.

Public entry points:
    brutefir_tpu.config.parse_config_file  -- parse a BruteFIR config
    brutefir_tpu.runtime.Engine            -- run a parsed config
"""

__version__ = "0.1.0"
