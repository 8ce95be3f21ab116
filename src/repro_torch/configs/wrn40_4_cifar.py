"""wrn40-4-cifar: the paper's own WideResNet-40-4."""
from repro_torch.models.vision import VisionConfig

CONFIG = VisionConfig(name="wrn40-4-cifar", n_classes=10, depth=40, width=4)
