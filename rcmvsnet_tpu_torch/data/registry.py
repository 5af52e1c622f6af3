"""Dataset registry: string → dataset class, mirroring
the reference's datasets/__init__.py:4-7."""
from __future__ import annotations

import importlib

_ALIASES = {
    "dtu_train": ("rcmvsnet_tpu_torch.data.dtu_train", "DTUTrainDataset"),
    "dtu_yao": ("rcmvsnet_tpu_torch.data.dtu_val", "DTUValDataset"),
    "dtu_test": ("rcmvsnet_tpu_torch.data.dtu_test", "DTUTestDataset"),
    "tanks": ("rcmvsnet_tpu_torch.data.tanks", "TanksDataset"),
    "synthetic": ("rcmvsnet_tpu_torch.data.synthetic_dataset", "SyntheticDataset"),
}


def find_dataset_def(name: str):
    module_name, cls_name = _ALIASES[name]
    module = importlib.import_module(module_name)
    return getattr(module, cls_name)
