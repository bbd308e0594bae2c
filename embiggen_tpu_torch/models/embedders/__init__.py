"""Node embedders ported so far."""
from .factorization import (
    MNMF, NMFADMM, NNSED, BoostNE, GraRep, NetMF, NodeSketch, RandNE, Role2Vec,
)
from .glove import DeepWalkGloVe, GloVe
from .line import FirstOrderLINE, SecondOrderLINE
from .minibatch import MinibatchEmbedder
from .siamese import SiameseEmbedder, StructuredEmbedding, TransE, TransH, Unstructured
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
           "MNMF", "NMFADMM", "NNSED"]
