"""vgg19-cifar: the paper's own VGG19 (the CIFAR adaptation of Liu et al.)."""
from repro_torch.models.vision import VisionConfig

CONFIG = VisionConfig(name="vgg19-cifar", n_classes=10)
