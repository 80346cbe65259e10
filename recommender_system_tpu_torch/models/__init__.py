from .afm import AFM
from .cf import ItemCF, UserCF
from .dcn import DCN
from .deep_crossing import DeepCrossing
from .deepfm import DeepFM
from .dien import DIEN
from .din import DIN
from .dssm import DSSM
from .ffm import FFM
from .fm import FM
from .fnn import FNN, init_from_fm
from .lr import fit_logistic_regression, predict_proba
from .lstm import LSTMClassifier
from .mf import matrix_factorization
from .mmoe import MMOE
from .nfm import NFM
from .pnn import PNN
from .transformer import Transformer, TransformerClassifier
from .wide_deep import WideDeep

# the JAX package's CTR models, under its names (DSSM and MMOE, a
# retrieval and a multi-task model, and the sequence classifiers are not
# among them, as in the JAX package)
CTR_MODELS = {
    "fm": FM, "ffm": FFM, "fnn": FNN, "wide_deep": WideDeep,
    "deepfm": DeepFM, "dcn": DCN, "deep_crossing": DeepCrossing,
    "pnn": PNN, "nfm": NFM, "afm": AFM, "din": DIN, "dien": DIEN,
}
