"""configs"""
