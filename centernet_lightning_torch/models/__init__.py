from . import backbones, heads, layers, meta, necks, tracker
from .backbones import BACKBONES, build_backbone
from .centernet import CenterNet
from .fairmot import FairMOT
from .heads import GenericHead, ReIDClassifier
from .meta import GenericModel, create_model, init_weights
from .necks import FPN, NECKS, build_neck
from .tracker import Tracker, build_tracker
