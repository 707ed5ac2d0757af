"""The benchmark of the PyTorch + CUDA port (``ros_stereo_slam_tpu_torch``).

Run one cell with ``python3 -m slambench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; ``BENCHMARK.json``
names the cells.  The frames, the vocabulary, the reference that decides
``correct`` (:mod:`slambench.reference`) and the arithmetic of the metrics
live here, so that a change to the program cannot change the yardstick.
Nothing here imports JAX or the JAX package.
"""
