from .dcn import DCN
from .deepfm import DeepFM
from .din import DIN
