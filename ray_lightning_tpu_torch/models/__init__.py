"""Model families ported so far: GPT (models/gpt.py) and BERT
(models/bert.py, over models/common.py's ``ClassificationModule``)."""
