"""Data layer: host-side ingest and batching.

See ``.datasets`` (decode/scan), ``.dicom`` (self-contained DICOM
parser), ``.loader`` (fixed-shape batches, device upload, dataset
statistics) and ``.mnist`` (local IDX files).
"""

from primia_tpu_torch.data.datasets import (  # noqa: F401
    CombinedLoader,
    Dataset,
    ImageFolderDataset,
    ImageFolderFromCSV,
    PPPP,
    PathDataset,
    Subset,
    pil_loader,
    random_split,
)
from primia_tpu_torch.data.dicom import DicomLoader, load_dcm, read_dicom, write_dicom  # noqa: F401
from primia_tpu_torch.data.loader import (  # noqa: F401
    Batch,
    BatchLoader,
    calc_mean_std,
    device_prefetch,
    to_device_resident,
)
from primia_tpu_torch.data.mnist import load_mnist, label_subset, resize_to  # noqa: F401
