"""The paper's own evaluation models: the VGG/ResNet family for 32x32
images (port of :mod:`repro.configs.paper_cnn`).

``vgg16_cifar`` / ``resnet18_cifar`` follow the paper's CIFAR-10
experiments (§5, Table 1); the ``*_small`` variants are CPU-trainable
reductions, the same code path with fewer channels.  :func:`regime` gives
the paper's training regimes (the settings of the reference's
``benchmarks/ablation_lib.py::method_config``).
"""
from repro_torch.configs.common import emt_preset
from repro_torch.core.emt_linear import EMTConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.models.cnn import CNNConfig


def vgg16_cifar(emt=None) -> CNNConfig:
    return CNNConfig(name="vgg16_cifar", arch="vgg",
                     channels=(64, 128, 256), blocks_per_stage=2,
                     num_classes=10, emt=emt or emt_preset())


def resnet18_cifar(emt=None) -> CNNConfig:
    return CNNConfig(name="resnet18_cifar", arch="resnet",
                     channels=(64, 128, 256), blocks_per_stage=2,
                     num_classes=10, emt=emt or emt_preset())


def vgg_small(emt=None) -> CNNConfig:
    return CNNConfig(name="vgg_small", arch="vgg",
                     channels=(16, 32), blocks_per_stage=1,
                     num_classes=4, image_size=16, emt=emt or emt_preset())


def resnet_small(emt=None) -> CNNConfig:
    return CNNConfig(name="resnet_small", arch="resnet",
                     channels=(16, 32), blocks_per_stage=1,
                     num_classes=4, image_size=16, emt=emt or emt_preset())


# the paper's regimes: (mode, trainable rho); technique B also needs
# lam > 0 in the train config
REGIMES = {"traditional": ("ideal", False), "A": ("analog", False),
           "A+B": ("analog", True), "A+B+C": ("bitserial", True)}


def regime(name: str, rho: float = 4.0, intensity: str = "normal"):
    """The EMTConfig of a paper regime: traditional (ideal, 8-bit
    fake-quantized), A (analog reads, fixed rho), A+B (trainable rho) or
    A+B+C (bit-serial reads, trainable rho)."""
    mode, trainable = REGIMES[name]
    if mode == "ideal":
        return EMTConfig(mode="ideal", quant=QuantConfig(8, 8, True))
    return emt_preset(mode, intensity=intensity, rho_init=rho).replace(
        trainable_rho=trainable)
