"""Port of the sba_tpu sub-package of the same name: the vocabulary
tree, the visual index and vote-and-verify."""

from sba_tpu_torch.retrieval.vocab_tree import (
    VocabTree,
    build_vocab_tree,
    quantize_descriptors,
)
from sba_tpu_torch.retrieval.visual_index import VisualIndex
