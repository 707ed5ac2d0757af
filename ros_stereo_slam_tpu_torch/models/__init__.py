from ros_stereo_slam_tpu_torch.models import frontend as frontend  # noqa: F401
from ros_stereo_slam_tpu_torch.models import pipeline as pipeline  # noqa: F401
from ros_stereo_slam_tpu_torch.models import state as state  # noqa: F401
