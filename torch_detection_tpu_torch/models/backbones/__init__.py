from .csp_darknet import CSPDarknet, CSPLayer, DarknetBottleneck, SPPBottleneck
from .darknet import DarkBlock, Darknet
from .mobilenet import DepthwiseSeparable, InvertedResidual, MobileNet, MobileNetV2
from .resnet import BasicBlock, Bottleneck, ResNet, ResNeXt, SEResNet, SEResNeXt
from .shufflenet import ShuffleBottleneck, ShuffleNet, ShuffleNetV2, ShuffleV2Block
from .ssd_vgg import SSDVGG, L2Norm
from .vgg import VGG

__all__ = ["BasicBlock", "Bottleneck", "CSPDarknet", "CSPLayer", "DarkBlock", "Darknet",
           "DarknetBottleneck", "DepthwiseSeparable", "InvertedResidual", "L2Norm", "MobileNet",
           "MobileNetV2", "ResNeXt", "ResNet", "SEResNeXt", "SEResNet", "SPPBottleneck", "SSDVGG",
           "ShuffleBottleneck", "ShuffleNet", "ShuffleNetV2", "ShuffleV2Block", "VGG"]
