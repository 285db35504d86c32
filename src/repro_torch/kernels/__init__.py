"""kernels"""
