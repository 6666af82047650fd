"""ResNet-18/CIFAR-10 trainer of the port."""
