"""flexibits"""
