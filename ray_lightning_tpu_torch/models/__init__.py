"""Model families ported so far: GPT (models/gpt.py) and its pipelined
form ``PipelinedGPT`` (models/pipeline_gpt.py), BERT
(models/bert.py) and ResNet (models/resnet.py), the last two over
models/common.py's ``ClassificationModule``, and the test fixtures
``BoringModel`` and ``LightningMNISTClassifier`` (models/boring.py)."""
