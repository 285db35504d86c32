"""flexibench"""
