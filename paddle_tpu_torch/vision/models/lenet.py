"""LeNet (``paddle_tpu.vision.models.lenet``; reference:
python/paddle/vision/models/lenet.py:21): two conv + ReLU + 2x2 max-pool
stages on a 1x28x28 input, then three linear layers.  The parameters
are drawn on the device ``set_device`` chose, else the current CUDA
device (raising when there is none)."""
from ... import nn


class LeNet(nn.Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120), nn.Linear(120, 84),
                nn.Linear(84, num_classes))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x
