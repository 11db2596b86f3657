"""The paper's FL model zoo (Tables 3 & 4) as ``ModelConfig`` CNN specs.

Group A: VGG16 (CIFAR-like 32x32x3), CNN-A (EMNIST-letters-like 28x28, 26 cls),
LeNet-5 (EMNIST-digits-like 28x28, 10 cls).
Group B: ResNet-18-thin (CIFAR-like; paper reports 598K params so the widths
are CIFAR-thin), CNN-B (Fashion-like 28x28), AlexNet-mini (MNIST-like 28x28;
paper reports 3,275K params).

BatchNorm is replaced by GroupNorm (stateless) — standard practice in FL where
per-device running statistics are ill-defined under non-IID data. Dropout in
CNN-B is omitted (inference-time identical). A copy of the reference's
``repro/configs/paper_models.py``.

CNN layer-spec mini-language (see models/cnn_zoo.py):
  ("conv",  out_c, k)        conv k×k stride 1 SAME + ReLU
  ("convp", out_c, k)        conv + ReLU + 2×2 maxpool
  ("gn",)                    GroupNorm over channels
  ("res",  out_c, stride)    basic residual block (2× conv3×3)
  ("flatten",)
  ("fc", width)              dense + ReLU
Final classifier to ``num_classes`` is implicit.
"""

from __future__ import annotations

from repro_torch.config.base import ArchFamily, JobConfig, ModelConfig
from repro_torch.config.registry import register_arch


def _cnn(name, spec, input_shape, num_classes) -> ModelConfig:
    return ModelConfig(
        name=name,
        family=ArchFamily.CNN,
        cnn_spec=tuple(spec),
        input_shape=tuple(input_shape),
        num_classes=num_classes,
    )


@register_arch("paper-vgg16")
def vgg16() -> ModelConfig:
    spec = [
        ("conv", 64, 3), ("convp", 64, 3),
        ("conv", 128, 3), ("convp", 128, 3),
        ("conv", 256, 3), ("conv", 256, 3), ("convp", 256, 3),
        ("conv", 512, 3), ("conv", 512, 3), ("convp", 512, 3),
        ("conv", 512, 3), ("conv", 512, 3), ("convp", 512, 3),
        ("flatten",), ("fc", 4096), ("fc", 4096),
    ]
    return _cnn("paper-vgg16", spec, (32, 32, 3), 10)


@register_arch("paper-cnn-a-iid")
def cnn_a_iid() -> ModelConfig:
    spec = [
        ("convp", 32, 3), ("gn",),
        ("convp", 64, 3), ("gn",),
        ("flatten",), ("fc", 1568), ("fc", 784),
    ]
    return _cnn("paper-cnn-a-iid", spec, (28, 28, 1), 26)


@register_arch("paper-cnn-a-noniid")
def cnn_a_noniid() -> ModelConfig:
    spec = [
        ("convp", 32, 3), ("convp", 64, 3), ("conv", 64, 3),
        ("flatten",), ("fc", 64),
    ]
    return _cnn("paper-cnn-a-noniid", spec, (28, 28, 1), 26)


@register_arch("paper-lenet5")
def lenet5() -> ModelConfig:
    spec = [("convp", 6, 5), ("convp", 16, 5), ("flatten",), ("fc", 120), ("fc", 84)]
    return _cnn("paper-lenet5", spec, (28, 28, 1), 10)


@register_arch("paper-resnet18")
def resnet18() -> ModelConfig:
    # CIFAR-thin ResNet-18 (paper Table 4: 598K params).
    spec = [
        ("conv", 16, 3),
        ("res", 16, 1), ("res", 16, 1),
        ("res", 32, 2), ("res", 32, 1),
        ("res", 64, 2), ("res", 64, 1),
        ("res", 128, 2), ("res", 128, 1),
        ("flatten",),
    ]
    return _cnn("paper-resnet18", spec, (32, 32, 3), 10)


@register_arch("paper-cnn-b")
def cnn_b() -> ModelConfig:
    spec = [("conv", 64, 2), ("conv", 32, 2), ("flatten",)]
    return _cnn("paper-cnn-b", spec, (28, 28, 1), 10)


@register_arch("paper-alexnet")
def alexnet() -> ModelConfig:
    # MNIST-scale AlexNet (paper Table 4: 3,275K params).
    spec = [
        ("convp", 32, 3), ("convp", 64, 3), ("conv", 128, 3),
        ("flatten",), ("fc", 512),
    ]
    return _cnn("paper-alexnet", spec, (28, 28, 1), 10)


# ---- the paper's job groups (3 jobs each, run in parallel) ----

def group_a(non_iid: bool = True):
    """VGG16 + CNN-A + LeNet5, targets from Table 1 (scaled to synthetic data)."""
    cnn_a = cnn_a_noniid() if non_iid else cnn_a_iid()
    return [
        JobConfig(job_id=0, model=vgg16(), target_metric=0.55 if non_iid else 0.60,
                  local_epochs=5, batch_size=30, lr=0.05),
        JobConfig(job_id=1, model=cnn_a, target_metric=0.80 if non_iid else 0.93,
                  local_epochs=5, batch_size=10, lr=0.05),
        JobConfig(job_id=2, model=lenet5(), target_metric=0.984 if non_iid else 0.993,
                  local_epochs=5, batch_size=64, lr=0.05),
    ]


def group_b(non_iid: bool = True):
    """ResNet18 + CNN-B + AlexNet, targets from Table 2 (scaled to synthetic data)."""
    return [
        JobConfig(job_id=0, model=resnet18(), target_metric=0.45 if non_iid else 0.74,
                  local_epochs=5, batch_size=30, lr=0.05),
        JobConfig(job_id=1, model=cnn_b(), target_metric=0.73 if non_iid else 0.865,
                  local_epochs=5, batch_size=10, lr=0.05),
        JobConfig(job_id=2, model=alexnet(), target_metric=0.978 if non_iid else 0.9933,
                  local_epochs=5, batch_size=64, lr=0.05),
    ]
