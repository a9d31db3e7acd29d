from sage_icp_tpu_torch.datasets.kitti import KittiOdometrySequence
from sage_icp_tpu_torch.datasets.kitti360 import Kitti360Sequence
from sage_icp_tpu_torch.datasets.kitti_raw import KittiRawSequence, discover_drives

__all__ = ["KittiOdometrySequence", "Kitti360Sequence", "KittiRawSequence", "discover_drives"]
