from ros_stereo_slam_tpu_torch.data import synthetic as synthetic  # noqa: F401
