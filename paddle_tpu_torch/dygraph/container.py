"""Layer containers (counterpart of paddle_tpu/dygraph/container.py;
reference: dygraph/container.py)."""
from .layers import Layer


class Sequential(Layer):
    def __init__(self, *layers):
        super(Sequential, self).__init__()
        for i, l in enumerate(layers):
            if isinstance(l, (list, tuple)):
                name, l = l
            else:
                name = str(i)
            self.add_sublayer(name, l)

    def forward(self, input):
        for l in self._sub_layers.values():
            input = l(input)
        return input

    def __getitem__(self, i):
        return list(self._sub_layers.values())[i]

    def __len__(self):
        return len(self._sub_layers)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super(LayerList, self).__init__()
        for i, l in enumerate(sublayers or []):
            self.add_sublayer(str(i), l)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._sub_layers)), sublayer)
        return self

    def __getitem__(self, i):
        return list(self._sub_layers.values())[i]

    def __iter__(self):
        return iter(self._sub_layers.values())

    def __len__(self):
        return len(self._sub_layers)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super(ParameterList, self).__init__()
        for i, p in enumerate(parameters or []):
            self.add_parameter(str(i), p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, i):
        return list(self._parameters.values())[i]

    def __iter__(self):
        return iter(self._parameters.values())

    def __len__(self):
        return len(self._parameters)
