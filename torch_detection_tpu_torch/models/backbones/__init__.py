from .resnet import BasicBlock, Bottleneck, ResNet

__all__ = ["BasicBlock", "Bottleneck", "ResNet"]
