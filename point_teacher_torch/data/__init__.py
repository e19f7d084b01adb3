from .coco import AITODDataset, CocoDetDataset  # noqa: F401
from .loader import EvalLoader, TrainLoader  # noqa: F401
from .sodaa import SODAADataset  # noqa: F401
