"""The plain reference that decides ``correct``.

Plain PyTorch and numpy, written for the benchmark: it imports nothing of
the program under test (``ros_stereo_slam_tpu_torch``) and takes nothing
the program made.  Each function takes a ``dtype``: float32 is the
configuration's precision; a lower one (bfloat16) is the control that has
to come out as not correct.

- :mod:`.trajectory`: Umeyama alignment and the absolute trajectory error;
- :mod:`.lk`: one Lucas-Kanade pyramid level (the work of kernel K1);
- :mod:`.orb`: rotated-BRIEF signs at given corners (kernel K2);
- :mod:`.vocab`: the vocabulary descent from packed descriptors to words
  (kernel K3), over the benchmark's own vocabulary tables.
"""
