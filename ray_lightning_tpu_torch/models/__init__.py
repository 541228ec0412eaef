"""Model families ported so far: GPT (models/gpt.py) and BERT
(models/bert.py, over models/common.py's ``ClassificationModule``), and
the test fixtures ``BoringModel`` and ``LightningMNISTClassifier``
(models/boring.py)."""
