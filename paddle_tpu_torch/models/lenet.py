"""LeNet-5 for MNIST (port of paddle_tpu/models/lenet.py): the
recognize_digits conv/pool/conv/pool/fc stack, NCHW."""

from .. import nn


class LeNet(nn.Layer):
    def __init__(self, num_classes=10, dtype="float32", **kw):
        super().__init__(dtype=dtype, **kw)
        sub = self.sub_kwargs()
        self.conv1 = nn.Conv2D(1, 20, 5, **sub)
        self.pool1 = nn.MaxPool2D(2, 2, **sub)
        self.conv2 = nn.Conv2D(20, 50, 5, **sub)
        self.pool2 = nn.MaxPool2D(2, 2, **sub)
        self.fc1 = nn.Linear(4 * 4 * 50, 500, **sub)
        self.fc2 = nn.Linear(500, num_classes, **sub)
        self.relu = nn.ReLU(**sub)

    def forward(self, x):
        # x: [B, 1, 28, 28]
        x = self.pool1(self.relu(self.conv1(x)))
        x = self.pool2(self.relu(self.conv2(x)))
        x = x.reshape(x.shape[0], -1)
        x = self.relu(self.fc1(x))
        return self.fc2(x)
