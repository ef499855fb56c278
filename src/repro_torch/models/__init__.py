"""The paper's four CNNs (VGG-16, MobileNet v1, ResNet-34, SqueezeNet)."""
