"""motioncheck_ccm_slam — collaborative monocular SLAM in JAX.

A JAX/XLA implementation of the capabilities of CCM-SLAM
(centralized collaborative monocular SLAM) plus the Motion Check GBA safeguard
(reference: taiyaki-go/motioncheck_ccm_slam, surveyed in SURVEY.md).

Package layout
--------------
- ``ops``      — numeric device kernels: Lie groups, projective geometry, ORB
                 pyramid extraction, descriptor matching, RANSAC solver
                 batteries, BoW vocabulary descent.
- ``solvers``  — batched Levenberg–Marquardt optimizers: motion-only pose
                 optimization, local/global bundle adjustment with Schur
                 complement, Sim3 refinement, essential-graph pose-graph
                 optimization.
- ``models``   — the SLAM data model and per-role pipelines: device-resident
                 SoA map state, frames, tracking, local mapping, loop closing,
                 map matching/merging, Motion Check.
- ``parallel`` — device-mesh sharding of the global bundle adjustment and the
                 agent<->server communication backend (ack/weak-ack protocol,
                 relative-pose message encoding).
- ``system``   — client/server assembly (ClientSystem/ServerSystem analogs).
- ``utils``    — ids, config, CSV trajectory IO, profiling, watchdog.

Design stance (vs the reference's thread-and-spinlock C++): a thin host
orchestration layer drives pure jitted kernels over fixed-capacity,
mask-validated SoA state; all O(features x keyframes) math runs on device.
"""

__version__ = "0.1.0"
