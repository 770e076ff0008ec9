"""The paper's own workload: HCK kernel ridge regression / GP configs (the
port's copy of ``repro.configs.hck_krr``).

Synthetic stand-ins at the sizes, dimensions and task types of the
paper's Table 1 (section 5); :func:`repro_torch.data.pipeline.
regression_dataset` draws data for a row, ``repro_torch.examples.
large_scale_krr`` fits it.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class HCKConfig:
    name: str
    n_train: int
    n_test: int
    d: int
    task: str              # regression | binary | multiclass
    n_classes: int = 0
    rank: int = 128
    leaf_size: int = 128
    kernel: str = "gaussian"
    sigma: float = 1.0
    lam: float = 1e-2


# Synthetic stand-ins mirroring Table 1 (size, dim, task)
DATASETS = {
    "cadata": HCKConfig("cadata", 16512, 4128, 8, "regression"),
    "yearpredictionmsd": HCKConfig("yearpredictionmsd", 463518, 51630, 90, "regression"),
    "ijcnn1": HCKConfig("ijcnn1", 35000, 91701, 22, "binary"),
    "covtype_binary": HCKConfig("covtype_binary", 464809, 116203, 54, "binary"),
    "susy": HCKConfig("susy", 4000000, 1000000, 18, "binary"),
    "mnist": HCKConfig("mnist", 60000, 10000, 780, "multiclass", n_classes=10),
    "acoustic": HCKConfig("acoustic", 78823, 19705, 50, "multiclass", n_classes=3),
    "covtype": HCKConfig("covtype", 464809, 116203, 54, "multiclass", n_classes=7),
}
