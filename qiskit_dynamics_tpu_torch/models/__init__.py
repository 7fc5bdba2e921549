"""Models: frames, operator collections, generator/Hamiltonian models."""
from .rotating_frame import RotatingFrame
from .operator_collections import OperatorCollection
from .generator_model import BaseGeneratorModel, GeneratorModel
from .hamiltonian_model import HamiltonianModel
from .rotating_wave_approximation import rotating_wave_approximation
