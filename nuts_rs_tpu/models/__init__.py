from .model import Model
from . import gaussian
from . import hierarchical
from . import stochastic_volatility
