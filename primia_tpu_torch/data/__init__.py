"""Data layer: host-side ingest and batching.

See ``.datasets`` (decode/scan), ``.dicom`` (self-contained DICOM
parser) and ``.loader`` (fixed-shape batches).
"""

from primia_tpu_torch.data.datasets import (  # noqa: F401
    CombinedLoader,
    Dataset,
    ImageFolderDataset,
    PathDataset,
    pil_loader,
)
from primia_tpu_torch.data.dicom import DicomLoader, load_dcm, read_dicom, write_dicom  # noqa: F401
from primia_tpu_torch.data.loader import Batch, BatchLoader  # noqa: F401
