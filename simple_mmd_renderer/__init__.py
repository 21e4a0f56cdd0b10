"""MMD engine in JAX: PMX/VMD loading, animation, physics, skinning and
software rendering as JAX/XLA/Pallas programs for the GPU.

Rebuilt from scratch with the capabilities of the reference C++ application
CU-Production/simple_mmd_renderer (see SURVEY.md)."""

__version__ = "0.1.0"
