from . import backbones, heads, layers, meta, necks
from .backbones import BACKBONES, build_backbone
from .centernet import CenterNet
from .heads import GenericHead
from .meta import GenericModel, create_model, init_weights
from .necks import FPN, NECKS, build_neck
