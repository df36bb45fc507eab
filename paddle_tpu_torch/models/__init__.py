"""Model zoo of the port (counterpart of paddle_tpu/models/): every model
of the JAX package's zoo.

- bert: BERT-base / ERNIE 1.0 and ERNIE 2.0 pretraining
- resnet: ResNet-50 image classification
- transformer: Transformer-base NMT
- deepfm: DeepFM CTR
- simple: the book's MLP and word2vec
- vision: MobileNet v1 / VGG-16 / SE-ResNeXt-50 classifiers
- yolov3: YOLOv3 detection (train: yolov3_loss; infer: yolo_box + NMS)
- sequence_labeling: BiGRU-CRF tagger (LAC)
- ocr: CRNN-CTC text recognition
- gpt: GPT-style causal LM with greedy decode
- dcgan: DCGAN adversarial training as one two-optimizer step
"""
from . import (bert, dcgan, deepfm, gpt, ocr, resnet,  # noqa: F401
               sequence_labeling, simple, transformer, vision, yolov3)
