from .csp_darknet import CSPDarknet, CSPLayer, DarknetBottleneck, SPPBottleneck
from .darknet import DarkBlock, Darknet
from .resnet import BasicBlock, Bottleneck, ResNet
from .ssd_vgg import SSDVGG, L2Norm
from .vgg import VGG

__all__ = ["BasicBlock", "Bottleneck", "CSPDarknet", "CSPLayer", "DarkBlock", "Darknet",
           "DarknetBottleneck", "L2Norm", "ResNet", "SPPBottleneck", "SSDVGG", "VGG"]
