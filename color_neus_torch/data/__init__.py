"""Data layer: host-side numpy loaders of the five dataset families (DTU,
BlendedMVS, IHO_VIDEO, OmniObject3D, Synthetic), registered on import.
The image files are read lazily (data/image_io.py): importing this
package imports no image library."""

from color_neus_torch.data import bmvs, dtu, iho_video, omniobject3d, synthetic  # noqa: F401
from color_neus_torch.data.base import BaseDataset, create_dataset  # noqa: F401
