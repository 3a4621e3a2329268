"""Caption metrics (counterparts of tell_tpu/evalm/): BLEU, ROUGE-L,
CIDEr-D, METEOR with this package's copy of its tables, entity P/R and
the readability fields. Pure Python, so each is a copy of the JAX
package's module; tests/test_torch_evalm.py holds them equal."""
from .bleu import bleu_scores, sentence_bleu
from .rouge import rouge_l
from .cider import CiderScorer
from .entities import entity_precision_recall
