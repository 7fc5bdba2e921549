"""Models: frames, operator collections, generator/Hamiltonian/Lindblad models."""
from .rotating_frame import RotatingFrame
from .operator_collections import OperatorCollection, VectorizedLindbladCollection
from .generator_model import BaseGeneratorModel, GeneratorModel
from .hamiltonian_model import HamiltonianModel
from .lindblad_model import LindbladModel
from .rotating_wave_approximation import rotating_wave_approximation
