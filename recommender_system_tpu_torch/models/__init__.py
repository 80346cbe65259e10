from .dcn import DCN
from .deepfm import DeepFM
