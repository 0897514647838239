"""better_flow — an accelerator-native event-stream motion-compensation framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
better-flow/better-flow (reference mounted at /root/reference): motion
compensation and optical-flow estimation for DVS/DAVIS event-camera streams.

Where the reference is an event-at-a-time C++/OpenCV/TBB pipeline (circular
buffer slices, per-event 4-parameter warp, time-image scatter-add,
Scharr-gradient descent on image sharpness), this framework operates on dense
fixed-shape SoA event tensors under jit:

* ``ops``      — the compute kernels: warp, time/count images (deterministic
                 scatter + box filter), masked Scharr gradients, model
                 reductions.  (reference: accel_lib.h, gpu_impl.cl)
* ``models``   — motion models and optimizers: global 4-parameter flow
                 (reference: optimizer_rolling.h, object_model.h/.cpp), local
                 2-parameter flow (optimizer_sampler.cpp), per-event score
                 search (optimizer_global.cpp).
* ``runtime``  — the streaming slice manager: ring buffer with count+span
                 eviction, dual triggers, warm-started slice chain.
                 (reference: dvs_flow.h, datastructures.h)
* ``parallel`` — multi-chip scale-out over a ``jax.sharding.Mesh``:
                 event-parallel scatter with psum'd images, spatially tiled
                 images with halo exchange, temporal slice parallelism.
                 (no reference counterpart — the reference is single-machine)
* ``io``       — event .txt readers/writers, bit-compatible with the
                 reference's format incl. its x/y swap (event_file.h).
* ``viz``      — projection / color-time / color-flow / gradient images
                 (event_file.h:292-747, event_file.cpp).
* ``eval``     — flow error metrics (the un-commented version of
                 event_file.cpp:122-279), PSNR, sharpness.
"""

from better_flow.config import (
    NZ,
    T_DIVIDER,
    UV_FACTOR,
    OptimizerConfig,
    PipelineConfig,
    SensorConfig,
    SliceConfig,
)

__version__ = "0.1.0"

__all__ = [
    "NZ",
    "T_DIVIDER",
    "UV_FACTOR",
    "SensorConfig",
    "SliceConfig",
    "OptimizerConfig",
    "PipelineConfig",
    "__version__",
]
