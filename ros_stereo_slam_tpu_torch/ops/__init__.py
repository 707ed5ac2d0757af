from ros_stereo_slam_tpu_torch.ops import grid as grid  # noqa: F401
from ros_stereo_slam_tpu_torch.ops import interp as interp  # noqa: F401
from ros_stereo_slam_tpu_torch.ops import lk as lk  # noqa: F401
from ros_stereo_slam_tpu_torch.ops import pyramid as pyramid  # noqa: F401
