"""Model configurations: ``cnn`` holds the ResNet-18 / MobileNet-V2
configs the compiler scales (the fp32 networks come with the model zoo)."""
