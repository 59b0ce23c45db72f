"""Design-record intersectors — counterpart of ``mitsuba3_tpu/ops/attic``.

As in the JAX package, these are on no dispatch path of the loader
(``MI3T_ACCEL`` never names them and ``load_dict`` never builds one): they
are called directly, by ``build`` and ``intersect_bvh`` / ``occluded_bvh``
of each module, as ``benchmarks/bench_bvh.py`` and the oracle tests call
JAX's. Each one's TPU kernels are hand-written CUDA kernels here:

- ``bvh_pallas``: packet BVH traversal per 1024-ray tile (K5,
  ``csrc/bvh_pallas_traverse.cu``);
- ``bvh_queue``: bvh_serve's leaves with an 8-deep queue of nearest leaves
  per ray (K6, K2's ``csrc/bvh_serve_cull.cu`` with 8 keys; K7
  ``csrc/bvh_queue_serve.cu``);
- ``bvh2``: 32-triangle supernodes served to 128-ray chunks by round
  (K8, ``csrc/bvh2_serve.cu``).
"""
