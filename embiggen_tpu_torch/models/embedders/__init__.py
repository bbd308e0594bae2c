"""Node embedders."""
from .factorization import (
    MNMF, NMFADMM, NNSED, BoostNE, GraRep, NetMF, NodeSketch, RandNE, Role2Vec,
)
from .glove import DeepWalkGloVe, GloVe
from .kge import (
    KGE_MODELS, RESCAL, AutoSF, BoxE, ComplEx, ConvE, CrossE, DistMA, DistMult, ERMLP, ERMLPE,
    HolE, KGEModel, NodePiece, PairRE, ProjE, QuatE, RotatE, TorusE, TransD, TransF, TransR,
    TuckER,
)
from .line import FirstOrderLINE, SecondOrderLINE
from .minibatch import MinibatchEmbedder
from .siamese import SiameseEmbedder, StructuredEmbedding, TransE, TransH, Unstructured
from .spectral import HOPE, GeometricLaplacianEigenmaps, LaplacianEigenmaps, SocioDim
from .spine import (
    RUBICONE, RUINE, DegreeSPINE, DegreeWINE, NodeLabelSPINE, NodeLabelWINE, ScoreSPINE,
    ScoreWINE, WeightedSPINE,
)
from .walk_based import (
    CBOW, DeepWalkCBOW, DeepWalkSkipGram, Node2Vec, SkipGram, WalkBasedEmbedder,
)
from .walklets import WalkletsCBOW, WalkletsGloVe, WalkletsSkipGram

__all__ = ["WalkBasedEmbedder", "SkipGram", "CBOW", "DeepWalkSkipGram",
           "DeepWalkCBOW", "Node2Vec", "MinibatchEmbedder", "FirstOrderLINE",
           "SecondOrderLINE", "SiameseEmbedder", "Unstructured", "TransE", "TransH",
           "StructuredEmbedding", "WalkletsSkipGram", "WalkletsCBOW", "WalkletsGloVe",
           "GloVe", "DeepWalkGloVe", "Role2Vec", "DegreeSPINE", "DegreeWINE",
           "NodeLabelSPINE", "NodeLabelWINE", "ScoreSPINE", "ScoreWINE", "WeightedSPINE",
           "RUBICONE", "RUINE", "NetMF", "GraRep", "BoostNE", "RandNE", "NodeSketch",
           "MNMF", "NMFADMM", "NNSED", "KGEModel", "KGE_MODELS", "TransR", "TransD",
           "TransF", "PairRE", "TorusE", "DistMult", "ComplEx", "RotatE", "HolE", "RESCAL",
           "TuckER", "QuatE", "DistMA", "AutoSF", "ProjE", "CrossE", "ERMLP", "ERMLPE",
           "ConvE", "BoxE", "NodePiece", "HOPE", "LaplacianEigenmaps",
           "GeometricLaplacianEigenmaps", "SocioDim"]
