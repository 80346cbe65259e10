from .dcn import DCN
from .deepfm import DeepFM
from .din import DIN
from .fm import FM
from .fnn import FNN, init_from_fm
from .nfm import NFM
from .wide_deep import WideDeep

# the Criteo CTR models that the port has, under the JAX package's names
CTR_MODELS = {
    "fm": FM, "fnn": FNN, "wide_deep": WideDeep, "deepfm": DeepFM, "dcn": DCN,
    "nfm": NFM, "din": DIN,
}
