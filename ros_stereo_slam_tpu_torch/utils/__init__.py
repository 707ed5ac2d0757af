from ros_stereo_slam_tpu_torch.utils import camera as camera  # noqa: F401
from ros_stereo_slam_tpu_torch.utils import lie as lie  # noqa: F401
