"""Node embedders ported so far."""
from .factorization import Role2Vec
from .glove import DeepWalkGloVe, GloVe
from .line import FirstOrderLINE, SecondOrderLINE
from .minibatch import MinibatchEmbedder
from .siamese import SiameseEmbedder, StructuredEmbedding, TransE, TransH, Unstructured
from .walk_based import (
    CBOW, DeepWalkCBOW, DeepWalkSkipGram, Node2Vec, SkipGram, WalkBasedEmbedder,
)
from .walklets import WalkletsCBOW, WalkletsGloVe, WalkletsSkipGram

__all__ = ["WalkBasedEmbedder", "SkipGram", "CBOW", "DeepWalkSkipGram",
           "DeepWalkCBOW", "Node2Vec", "MinibatchEmbedder", "FirstOrderLINE",
           "SecondOrderLINE", "SiameseEmbedder", "Unstructured", "TransE", "TransH",
           "StructuredEmbedding", "WalkletsSkipGram", "WalkletsCBOW", "WalkletsGloVe",
           "GloVe", "DeepWalkGloVe", "Role2Vec"]
