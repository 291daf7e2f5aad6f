from .darknet import DarkBlock, Darknet
from .resnet import BasicBlock, Bottleneck, ResNet
from .ssd_vgg import SSDVGG, L2Norm
from .vgg import VGG

__all__ = ["BasicBlock", "Bottleneck", "DarkBlock", "Darknet", "L2Norm", "ResNet", "SSDVGG",
           "VGG"]
