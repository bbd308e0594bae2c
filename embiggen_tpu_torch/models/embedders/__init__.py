"""Node embedders ported so far."""
from .walk_based import (
    CBOW, DeepWalkCBOW, DeepWalkSkipGram, Node2Vec, SkipGram, WalkBasedEmbedder,
)

__all__ = ["WalkBasedEmbedder", "SkipGram", "CBOW", "DeepWalkSkipGram",
           "DeepWalkCBOW", "Node2Vec"]
