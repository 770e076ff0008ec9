"""Kernel packages of the port: plain versions and CUDA C++ wrappers."""
