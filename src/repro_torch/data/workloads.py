"""The paper's query workloads (Appendix F) — 12 queries per dataset,
grouped Small (1 operator, q1-q4), Medium (2-3 operators, q5-q8), Large
(4+ operators, q9-q12).

Queries are transcribed from Listings 2-4. The Game listing truncates after
q10 in the paper PDF; q11/q12 follow the stated pattern for Large queries
(4+ operators ending in a single-value reduce).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List

from repro_torch.core.dataframe import SemanticDataFrame
from repro_torch.core.table import Table


@dataclasses.dataclass
class Query:
    qid: str
    size: str            # S | M | L
    question: str
    build: Callable[[SemanticDataFrame], SemanticDataFrame]

    def plan_for(self, table: Table):
        return self.build(SemanticDataFrame(table)).plan()


def _q(qid, size, question, build):
    return Query(qid, size, question, build)


MOVIE: List[Query] = [
    _q("q1", "S", "Extract the genres of all movies",
       lambda df: df.semantic_map(
           "According to the movie plot, extract the genre(s) of each "
           "movie.", "Plot", "Genre")),
    _q("q2", "S", "Find all movies directed by Christopher Nolan",
       lambda df: df.semantic_filter(
           "The movie is directed by Christopher Nolan.", "Director")),
    _q("q3", "S", "Find all movies whose poster is in the dark style",
       lambda df: df.semantic_filter(
           "Whether the movie poster image is in the dark style.",
           "Poster")),
    _q("q4", "S", "Find all movies that won more than 3 Oscars",
       lambda df: df.semantic_filter(
           "Whether the movie has ever won more than 3 Oscars?", "Awards")),
    _q("q5", "M", "Total box office of movies rated above 9",
       lambda df: df.semantic_filter(
           "The rating is higher than 9.", "IMDB_rating")
       .semantic_reduce("Compute the total box office gross.", "BoxOffice")),
    _q("q6", "M", "Count movies directed by Quentin Tarantino",
       lambda df: df.semantic_filter(
           "The movie is directed by Quentin Tarantino.", "Director")
       .semantic_reduce("Count the number of movies.", "Title")),
    _q("q7", "M", "Genre of the highest-rated Spielberg movie",
       lambda df: df.semantic_map(
           "According to the movie plot, extract the genre(s) of each "
           "movie.", "Plot", "Genre")
       .semantic_filter("The movie is directed by Steven Spielberg.",
                        "Director")
       .semantic_reduce("Find the highest rate in the rest movie.",
                        "IMDB_rating")),
    _q("q8", "M", "Count movies that won 2 Oscars with rating above 9",
       lambda df: df.semantic_filter(
           "The rating is higher than 9.", "IMDB_rating")
       .semantic_filter("Whether the movie has won 2 Oscars.", "Awards")
       .semantic_reduce("Count the number of movies.", "Title")),
    _q("q9", "L", "Max rating of crime movies rated in (8.5, 9)",
       lambda df: df.semantic_map(
           "According to the movie plot, extract the genre(s) of each "
           "movie.", "Plot", "Genre")
       .semantic_filter("The rating is higher than 8.5.", "IMDB_rating")
       .semantic_filter("The rating is lower than 9.", "IMDB_rating")
       .semantic_filter("The movie belongs to crime movies.", "Genre")
       .semantic_reduce("Find the maximum rating in the rest movies.",
                        "IMDB_rating")),
    _q("q10", "L", "Count crime movies rated in (8.5, 9)",
       lambda df: df.semantic_map(
           "According to the movie plot, extract the genre(s) of each "
           "movie.", "Plot", "Genre")
       .semantic_filter("The rating is higher than 8.5.", "IMDB_rating")
       .semantic_filter("The rating is lower than 9.", "IMDB_rating")
       .semantic_filter("The movie belongs to crime movies.", "Genre")
       .semantic_reduce("Count the number of crime movies.", "Title")),
    _q("q11", "L", "Average runtime of crime movies rated above 9",
       lambda df: df.semantic_map(
           "According to the movie plot, extract the genre(s) of each "
           "movie.", "Plot", "Genre")
       .semantic_filter("The rating is higher than 9.", "IMDB_rating")
       .semantic_filter("The movie belongs to crime movies.", "Genre")
       .semantic_reduce("Compute the average movie runtime.", "Runtime")),
    _q("q12", "L", "Main characters of crime movies rated above 9",
       lambda df: df.semantic_map(
           "According to the movie plot, extract the genre(s) of each "
           "movie.", "Plot", "Genre")
       .semantic_filter("The rating is higher than 9.", "IMDB_rating")
       .semantic_filter("The movie belongs to crime movies.", "Genre")
       .semantic_map("Extract the main character from the movie plot.",
                     "Plot", "Character")),
]


ESTATE: List[Query] = [
    _q("q1", "S", "Find houses with a yard",
       lambda df: df.semantic_filter(
           "Observed from the house picture, whether the house has a yard "
           "or not.", "image")),
    _q("q2", "S", "Extract house prices from details",
       lambda df: df.semantic_map(
           "Extract the house price from the detail about the estate.",
           "Details", "Price")),
    _q("q3", "S", "Houses located in Ajah, Lagos",
       lambda df: df.semantic_filter(
           "Whether the house is located in Ajah, Lagos.", "Location")),
    _q("q4", "S", "Extract amenities of the estates",
       lambda df: df.semantic_map(
           "Extract Amenities of the estate from the estate details.",
           "Details", "Amenities")),
    _q("q5", "M", "Amenities of estates with 4-5 bedrooms",
       lambda df: df.semantic_filter(
           "Whether the estate has more than 3 bedrooms", "Title")
       .semantic_map("Extract Amenities of the estate from the estate "
                     "details.", "Details", "Amenities")
       .semantic_filter("Whether the estate has less than 6 bedrooms.",
                        "Title")),
    _q("q6", "M", "Average price of estates with a yard",
       lambda df: df.semantic_map(
           "Extract the house price from the detail about the estate.",
           "Details", "Price")
       .semantic_filter("Observed from the house picture, whether the "
                        "house has a yard or not.", "image")
       .semantic_reduce("Compute the average price for the estates.",
                        "Price")),
    _q("q7", "M", "Features of 2-3 bedroom estates",
       lambda df: df.semantic_map(
           "Extract features from the detail about the estate.", "Details",
           "Features")
       .semantic_filter("Whether the estate has 2 or 3 bedrooms", "Title")),
    _q("q8", "M", "Amenities of 2-3 bedroom estates",
       lambda df: df.semantic_map(
           "Extract amenities from the detail about the estate.", "Details",
           "Amenities")
       .semantic_filter("Whether the estate has 2 or 3 bedrooms", "Title")),
    _q("q9", "L", "Average price of 4-5 bedroom estates",
       lambda df: df.semantic_map(
           "Extract the house price from the detail about the estate.",
           "Details", "Price")
       .semantic_filter("Whether the estate has more than 3 bedrooms",
                        "Title")
       .semantic_filter("Whether the estate has less than 6 bedrooms.",
                        "Title")
       .semantic_reduce("Compute the average price for the estates.",
                        "Price")),
    _q("q10", "L", "Lowest price of 4-5 bedroom detached duplexes",
       lambda df: df.semantic_map(
           "Extract the house price from the detail about the estate.",
           "Details", "Price")
       .semantic_filter("Whether the estate has more than 3 bedrooms.",
                        "Title")
       .semantic_filter("Whether the estate has less than 6 bedrooms.",
                        "Title")
       .semantic_filter("Whether the estate is a detached duplex.", "Title")
       .semantic_reduce("Compute the lowest price for the estates.",
                        "Price")),
    _q("q11", "L", "Lowest price of estates with a swimming pool",
       lambda df: df.semantic_map(
           "Extract the house price from the detail about the estate.",
           "Details", "Price")
       .semantic_map("Extract the amenities from the estate details.",
                     "Details", "Amenities")
       .semantic_filter("Is there a swimming pool in the estate.",
                        "Amenities")
       .semantic_reduce("Compute the lowest price for the estates.",
                        "Price")),
    _q("q12", "L", "Average price: gym + pool + Lekki",
       lambda df: df.semantic_map(
           "Extract the house price from the detail about the estate.",
           "Details", "Price")
       .semantic_map("Extract the amenities from the estate details.",
                     "Details", "Amenities")
       .semantic_filter("Is there a swimming pool in the estate.",
                        "Amenities")
       .semantic_filter("Is there a gym in the estate.", "Amenities")
       .semantic_filter("Is the estate located in Lekki, Lagos.",
                        "Location")
       .semantic_reduce("Compute the average price for the estates.",
                        "Price")),
]


GAME: List[Query] = [
    _q("q1", "S", "Games suitable only for adults (PEGI)",
       lambda df: df.semantic_filter(
           "According to the given PEGI rating (in picture), check if the "
           "game is only suitable for adults (18 years or older).",
           "rating")),
    _q("q2", "S", "Binary review labels",
       lambda df: df.semantic_map(
           "Give the video game a binary review (positive or negative) "
           "based on the existing review.", "overall_reviews", "comments")),
    _q("q3", "S", "Games that support VR",
       lambda df: df.semantic_filter(
           "Does the video game support VR?", "platforms")),
    _q("q4", "S", "Games with MetaCritic above 90",
       lambda df: df.semantic_filter(
           "The rating is higher than 90.", "metacriticts")),
    _q("q5", "M", "Top publisher of sports games",
       lambda df: df.semantic_map(
           "Extract the genre from the brief summary of the game.",
           "description", "genre")
       .semantic_filter("The video game is about sports.", "genre")
       .semantic_reduce("Find the publisher that appears the most.",
                        "publisher")),
    _q("q6", "M", "Lowest discounted price among MacOS games",
       lambda df: df.semantic_filter(
           "Is MacOS in the list of supported platforms?", "platforms")
       .semantic_reduce("Find the lowest price.", "discounted_price")),
    _q("q7", "M", "Shooting games supporting Chinese",
       lambda df: df.semantic_map(
           "Extract the genre from the brief summary of the game.",
           "description", "genre")
       .semantic_filter("The video game is about shooting.", "genre")
       .semantic_filter("Is Chinese one of the supported languages?",
                        "language")),
    _q("q8", "M", "Count single-developer games rated above 90",
       lambda df: df.semantic_filter(
           "The rating is higher than 90.", "metacriticts")
       .semantic_filter("Does the video game has only one developer?",
                        "developer")
       .semantic_reduce("Count the number of games.", "title")),
    _q("q9", "L", "Average USD price of VR shooting games",
       lambda df: df.semantic_map(
           "Extract the genre from the brief summary of the game.",
           "description", "genre")
       .semantic_filter("Does the game support VR.", "platforms")
       .semantic_filter("The game is a shooting game", "genre")
       .semantic_map("Convert the price in IDR into the price in USD.",
                     "discounted_price", "price_usd")
       .semantic_reduce("Compute the average price in USD of games.",
                        "price_usd")),
    _q("q10", "L", "Average price: Windows+MacOS, positive reviews",
       lambda df: df.semantic_map(
           "Convert the price in IDR into the price in USD.",
           "discounted_price", "price_usd")
       .semantic_filter("Does the game supports both Windows and MacOS?",
                        "platforms")
       .semantic_filter("Does the game receive a positive review?",
                        "overall_reviews")
       .semantic_reduce("Compute the average price in USD of games.",
                        "price_usd")),
    _q("q11", "L", "Count adult strategy games rated above 80",
       lambda df: df.semantic_map(
           "Extract the genre from the brief summary of the game.",
           "description", "genre")
       .semantic_filter("The rating is higher than 80.", "metacriticts")
       .semantic_filter("The game is a strategy game", "genre")
       .semantic_filter("According to the given PEGI rating (in picture), "
                        "check if the game is only suitable for adults (18 "
                        "years or older).", "rating")
       .semantic_reduce("Count the number of games.", "title")),
    _q("q12", "L", "Average MetaCritic of positive-review VR games",
       lambda df: df.semantic_map(
           "Give the video game a binary review (positive or negative) "
           "based on the existing review.", "overall_reviews", "comments")
       .semantic_filter("Does the video game support VR?", "platforms")
       .semantic_filter("The review is positive.", "comments")
       .semantic_reduce("Compute the average rating of the games.",
                        "metacriticts")),
]


WORKLOADS = {"movie": MOVIE, "estate": ESTATE, "game": GAME}


def by_size(dataset: str, size: str) -> List[Query]:
    return [q for q in WORKLOADS[dataset] if q.size == size]
