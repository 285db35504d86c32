"""models"""
